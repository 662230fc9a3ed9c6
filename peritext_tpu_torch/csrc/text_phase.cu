// Text phase of the exact merge: RGA inserts, fused insert runs and deletes,
// applied in op order, one thread block per replica.
//
// Replaces: peritext_tpu/ops/pallas_kernels.py, _text_kernel (entry
// text_phase_pallas).  Semantics follow kernels._apply_text_op /
// _rga_insert_position (peritext_tpu/ops/kernels.py), which is what the JAX
// universe runs: an insert whose reference element is absent goes after
// element 0 (argmax over all-False), where the Pallas kernel drops it.
//
// What bounds it on an H100: the bytes are small -- each replica's six
// int32 planes (elem_ctr, elem_act, actor rank, deleted, chars, orig_idx)
// are read once from device memory and written once, 48 KiB per replica at
// C = 2048.  The time goes to the op-serial chain inside a block: every
// insert needs two block-wide min-reductions (the reference index, then the
// stop position t of the skip run) and an in-place shift of the planes by k,
// each separated by __syncthreads.  Ops of one replica cannot overlap.
//
// What the design does about it: all six planes live in dynamic shared
// memory for the whole op list, so the serial chain touches no device
// memory except the op rows (read once, broadcast to the block).  The
// reductions are warp __reduce_min_sync plus one shared-memory step; the
// shift runs from the top of the array down in block-sized chunks with one
// barrier per chunk and only over [t + k, C).  Replicas are independent
// blocks, so R = 1024 fills the card's 132 SMs several blocks deep.
// Shared memory is 24 * C bytes plus scratch: C <= 8192 fits the 227 KB a
// block may use; the wrapper refuses larger C.

#include "common.cuh"

namespace {

using namespace pt;

__global__ void __launch_bounds__(THREADS) text_phase_kernel(
    const int* __restrict__ ec_in, const int* __restrict__ ea_in,
    const uint8_t* __restrict__ dl_in, const int* __restrict__ ch_in,
    const int* __restrict__ len_in, const int* __restrict__ ops, int num_ops,
    const int* __restrict__ ranks, int num_ranks,
    const int* __restrict__ char_buf, int buf_len,
    int* __restrict__ ec_out, int* __restrict__ ea_out,
    uint8_t* __restrict__ dl_out, int* __restrict__ ch_out,
    int* __restrict__ oi_out, int* __restrict__ len_out, int cap) {
  extern __shared__ int smem[];
  int* ec = smem;
  int* ea = ec + cap;
  int* er = ea + cap;
  int* dl = er + cap;
  int* ch = dl + cap;
  int* oi = ch + cap;
  int* scratch = oi + cap;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(r) * cap;

  for (int p = tid; p < cap; p += nt) {
    const int a = ea_in[base + p];
    ec[p] = ec_in[base + p];
    ea[p] = a;
    er[p] = ranks[clampi(a, 0, num_ranks - 1)];
    dl[p] = dl_in[base + p] != 0;
    ch[p] = ch_in[base + p];
    oi[p] = p;
  }
  int length = len_in[r];
  __syncthreads();

  const int* rops = ops + static_cast<size_t>(r) * num_ops * OP_FIELDS;
  const int* rbuf = char_buf + static_cast<size_t>(r) * buf_len;
  for (int l = 0; l < num_ops; ++l) {
    const int* op = rops + l * OP_FIELDS;
    const int kind = op[K_KIND];
    const int ref_ctr = op[K_REF_CTR];
    const int ref_act = op[K_REF_ACT];
    const bool is_run = kind == KIND_INSERT_RUN && buf_len > 0;

    if (kind == KIND_DELETE) {
      for (int p = tid; p < length && p < cap; p += nt) {
        if (ec[p] == ref_ctr && ea[p] == ref_act) dl[p] = 1;
      }
      __syncthreads();
      continue;
    }
    if (kind != KIND_INSERT && !is_run) continue;  // uniform per block

    // Reference element: first live match, 0 when absent, -1 for HEAD.
    int idx = -1;
    if (ref_ctr != 0 || ref_act != 0) {
      int first = cap;
      for (int p = tid; p < length && p < cap; p += nt) {
        if (ec[p] == ref_ctr && ea[p] == ref_act) {
          first = p;
          break;
        }
      }
      first = block_min(first, scratch);
      idx = first == cap ? 0 : first;
    }

    // Stop of the skip run: first p > idx that is dead or has a smaller id.
    const int ctr = op[K_CTR];
    const int act = op[K_ACT];
    const int op_rank = ranks[clampi(act, 0, num_ranks - 1)];
    int t = cap;
    for (int p = tid; p < cap; p += nt) {
      if (p <= idx) continue;
      const int c = ec[p];
      const bool gt = c > ctr || (c == ctr && er[p] > op_rank);
      if (!(p < length && gt)) {
        t = p;
        break;
      }
    }
    t = block_min(t, scratch);
    const int k = is_run ? op[K_RUN_LEN] : 1;

    // Shift [t, C - k) right by k, in block-sized chunks from the top down.
    // A chunk reads p - k before its barrier and writes p after it.  It
    // never reads what a higher chunk wrote, and the next lower chunk writes
    // only after its own barrier, which no thread passes before every thread
    // has finished this chunk's reads: one barrier per chunk suffices.
    const int lo = t + k;
    for (int top = cap; top > lo; top -= nt) {
      const int p = top - 1 - tid;
      const bool mine = p >= lo;
      int v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0, v5 = 0;
      if (mine) {
        const int q = p - k;
        v0 = ec[q]; v1 = ea[q]; v2 = er[q]; v3 = dl[q]; v4 = ch[q]; v5 = oi[q];
      }
      __syncthreads();
      if (mine) {
        ec[p] = v0; ea[p] = v1; er[p] = v2; dl[p] = v3; ch[p] = v4; oi[p] = v5;
      }
    }

    // The inserted block [t, t + k).
    const int payload = op[K_PAYLOAD];
    const int start = is_run ? clampi(payload, 0, buf_len - MAX_RUN_LEN) : 0;
    for (int off = tid; off < k; off += nt) {
      const int p = t + off;
      if (p >= cap) break;
      ec[p] = ctr + off;
      ea[p] = act;
      er[p] = op_rank;
      dl[p] = 0;
      ch[p] = is_run ? rbuf[start + (off < MAX_RUN_LEN ? off : MAX_RUN_LEN - 1)] : payload;
      oi[p] = -1;
    }
    length += k;
    __syncthreads();
  }

  for (int p = tid; p < cap; p += nt) {
    ec_out[base + p] = ec[p];
    ea_out[base + p] = ea[p];
    dl_out[base + p] = static_cast<uint8_t>(dl[p]);
    ch_out[base + p] = ch[p];
    oi_out[base + p] = oi[p];
  }
  if (tid == 0) len_out[r] = length;
}

}  // namespace

extern "C" size_t pt_text_phase_smem(int cap) {
  return (6 * static_cast<size_t>(cap) + SCRATCH_INTS) * sizeof(int);
}

// Launches the text phase on ``stream``; returns the CUDA error code of the
// launch (0 on success).  Pointers are device pointers of contiguous
// tensors: planes [R, C], ops [R, L, 15], ranks [A], char_buf [R, buf_len]
// (buf_len 0: no run buffer, KIND_INSERT_RUN rows are no-ops).
extern "C" int pt_text_phase(
    const void* ec_in, const void* ea_in, const void* dl_in, const void* ch_in,
    const void* len_in, const void* ops, int num_ops, const void* ranks,
    int num_ranks, const void* char_buf, int buf_len, void* ec_out,
    void* ea_out, void* dl_out, void* ch_out, void* oi_out, void* len_out,
    int replicas, int cap, void* stream) {
  if (replicas == 0) return 0;
  const size_t smem = pt_text_phase_smem(cap);
  cudaError_t err = cudaFuncSetAttribute(
      text_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  text_phase_kernel<<<replicas, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ec_in), static_cast<const int*>(ea_in),
      static_cast<const uint8_t*>(dl_in), static_cast<const int*>(ch_in),
      static_cast<const int*>(len_in), static_cast<const int*>(ops), num_ops,
      static_cast<const int*>(ranks), num_ranks,
      static_cast<const int*>(char_buf), buf_len, static_cast<int*>(ec_out),
      static_cast<int*>(ea_out), static_cast<uint8_t*>(dl_out),
      static_cast<int*>(ch_out), static_cast<int*>(oi_out),
      static_cast<int*>(len_out), cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
