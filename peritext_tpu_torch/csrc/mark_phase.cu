// Mark phase of the exact merge: addMark/removeMark ops applied to the
// boundary bitsets in op order, one thread block per replica.
//
// Replaces: peritext_tpu/ops/pallas_kernels.py, _mark_kernel (entry
// mark_phase_pallas).  Semantics follow kernels._apply_mark_fast
// (peritext_tpu/ops/kernels.py).  Per op:
//   - resolve the start and end anchors to boundary slots (first live match,
//     slot 0 when absent; endOfText is 2C + 2, and s == e becomes endOfText);
//   - read both carry rows -- the nearest defined slot at or left of s, and
//     of min(e, 2C - 1) -- before any write;
//   - OR bit m % 32 of word m / 32 into the defined slots inside (s, e);
//   - write slot s as carry(s) | bit and slot e as carry(e) unless e is
//     endOfText, and mark both defined.
// m is the replica's running mark count; when m >= M the bit drops (the
// JAX scatter's drop mode) but the anchor slots are still written.
//
// What bounds it on an H100: bytes.  The [2C, W] mask plane of one replica
// is 2 * C * W * 4 bytes -- 512 KiB at C = 2048, W = 32 -- far over the
// 227 KB of shared memory a block may use, so it stays in device memory.
// The kernel's output is a new plane, so the whole plane is read once and
// written once (copied at entry, then updated in place); at R = 1024 that
// copy is 1 GiB of traffic, which sets the least time.  On top of it sits
// the op-serial chain: per op two block-wide reductions and one barrier to
// publish the carry rows.
//
// What the design does about it: per op the kernel touches only what
// _apply_mark_fast changes -- word column m / 32 of the defined slots in
// (s, e), the two carry rows (W words each) and the rows of slots s and e.
// The column access is strided (stride W * 4 bytes, one 32-byte sector per
// slot): the known cost of keeping the slot-major [2C, W] layout that the
// rest of the port and the JAX package share.  Definedness and the element
// ids live in shared memory, so anchor resolution and the carry searches
// read no device memory: 10 bytes per element (ids 8, definedness one byte
// per slot), so C = 16384 with W = 32 takes 164,352 bytes.

#include "common.cuh"

namespace {

using namespace pt;

__global__ void __launch_bounds__(THREADS) mark_phase_kernel(
    const uint8_t* __restrict__ def_in, const int* mask_in,
    const int* __restrict__ ec_in, const int* __restrict__ ea_in,
    const int* __restrict__ len_in, const int* __restrict__ mc_in,
    const int* __restrict__ ops, int num_ops, uint8_t* __restrict__ def_out,
    int* mask_out, int cap, int words) {
  extern __shared__ int smem[];
  const int two_c = 2 * cap;
  int* ec = smem;
  int* ea = ec + cap;
  int* row_s = ea + cap;
  int* row_e = row_s + words;
  int* scratch = row_e + words;
  uint8_t* def = reinterpret_cast<uint8_t*>(scratch + SCRATCH_INTS);  // one byte per slot

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t plane = static_cast<size_t>(two_c) * words;
  int* mask = mask_out + r * plane;

  if (mask_in != mask_out) {
    const int* src = mask_in + r * plane;
    const uintptr_t both = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(mask);
    if (plane % 4 == 0 && both % 16 == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(mask);
      for (size_t i = tid; i < plane / 4; i += nt) d4[i] = s4[i];
    } else {
      for (size_t i = tid; i < plane; i += nt) mask[i] = src[i];
    }
  }
  for (int p = tid; p < two_c; p += nt) {
    def[p] = def_in[static_cast<size_t>(r) * two_c + p] != 0;
  }
  for (int p = tid; p < cap; p += nt) {
    ec[p] = ec_in[static_cast<size_t>(r) * cap + p];
    ea[p] = ea_in[static_cast<size_t>(r) * cap + p];
  }
  const int length = len_in[r];
  const int live_slots = 2 * length;
  const int big = two_c + 2;
  int m = mc_in[r];
  __syncthreads();

  const int* rops = ops + static_cast<size_t>(r) * num_ops * OP_FIELDS;
  for (int l = 0; l < num_ops; ++l) {
    const int* op = rops + l * OP_FIELDS;
    if (op[K_KIND] != KIND_MARK) continue;  // uniform per block

    // Anchors: first live match of each, 0 when absent.
    const int sctr = op[K_SCTR], sact = op[K_SACT];
    const int ectr = op[K_ECTR], eact = op[K_EACT];
    int fs = cap, fe = cap;
    for (int p = tid; p < length && p < cap; p += nt) {
      const int c = ec[p], a = ea[p];
      if (c == sctr && a == sact && p < fs) fs = p;
      if (c == ectr && a == eact && p < fe) fe = p;
    }
    block_min2(fs, fe, scratch);
    const int s_slot = 2 * (fs == cap ? 0 : fs) + op[K_SKIND];
    const int ekind = op[K_EKIND];
    int e_slot = ekind == 2 ? big : 2 * (fe == cap ? 0 : fe) + (ekind < 1 ? ekind : 1);
    if (e_slot == s_slot) e_slot = big;
    const int e_clamped = e_slot < two_c - 1 ? e_slot : two_c - 1;

    // Carry sources: nearest defined slot at or left of s and of e.
    int src_s = -1, src_e = -1;
    for (int p = tid; p < two_c && p < live_slots; p += nt) {
      if (def[p]) {
        if (p <= s_slot) src_s = p;
        if (p <= e_clamped) src_e = p;
      }
    }
    block_max2(src_s, src_e, scratch);
    for (int w = tid; w < words; w += nt) {
      row_s[w] = src_s >= 0 ? mask[static_cast<size_t>(src_s) * words + w] : 0;
      row_e[w] = src_e >= 0 ? mask[static_cast<size_t>(src_e) * words + w] : 0;
    }
    __syncthreads();

    // The three write classes touch disjoint words: (s, e), s, e.
    const int word = m >> 5;
    const unsigned bit = 1u << (m & 31);
    const bool write_s = s_slot < e_slot;
    const bool write_e = e_slot < two_c;
    if (write_s) {
      if (word < words) {
        const int hi = min(e_slot, min(live_slots, two_c));
        for (int p = s_slot + 1 + tid; p < hi; p += nt) {
          if (def[p]) {
            int* cell = mask + static_cast<size_t>(p) * words + word;
            *cell = static_cast<int>(static_cast<unsigned>(*cell) | bit);
          }
        }
      }
      for (int w = tid; w < words; w += nt) {
        const unsigned v = static_cast<unsigned>(row_s[w]) | (w == word ? bit : 0u);
        mask[static_cast<size_t>(s_slot) * words + w] = static_cast<int>(v);
      }
    }
    if (write_e) {
      for (int w = tid; w < words; w += nt) {
        mask[static_cast<size_t>(e_slot) * words + w] = row_e[w];
      }
    }
    if (tid == 0) {
      if (write_s) def[s_slot] = 1;
      if (write_e) def[e_slot] = 1;
    }
    ++m;
    __syncthreads();
  }

  for (int p = tid; p < two_c; p += nt) {
    def_out[static_cast<size_t>(r) * two_c + p] = static_cast<uint8_t>(def[p]);
  }
}

}  // namespace

extern "C" size_t pt_mark_phase_smem(int cap, int words) {
  return (2 * static_cast<size_t>(cap) + 2 * static_cast<size_t>(words) + SCRATCH_INTS) *
             sizeof(int) +
         2 * static_cast<size_t>(cap);
}

// Launches the mark phase on ``stream``; returns the CUDA error code of the
// launch (0 on success).  Planes: def [R, 2C] uint8, mask [R, 2C, W] int32
// (mask_out may equal mask_in for an in-place update), element ids [R, C],
// length and mark count [R], ops [R, L, 15].
extern "C" int pt_mark_phase(
    const void* def_in, const void* mask_in, const void* ec_in, const void* ea_in,
    const void* len_in, const void* mc_in, const void* ops, int num_ops,
    void* def_out, void* mask_out, int replicas, int cap, int words,
    void* stream) {
  if (replicas == 0) return 0;
  const size_t smem = pt_mark_phase_smem(cap, words);
  cudaError_t err = cudaFuncSetAttribute(
      mark_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mark_phase_kernel<<<replicas, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(def_in), static_cast<const int*>(mask_in),
      static_cast<const int*>(ec_in), static_cast<const int*>(ea_in),
      static_cast<const int*>(len_in), static_cast<const int*>(mc_in),
      static_cast<const int*>(ops), num_ops, static_cast<uint8_t*>(def_out),
      static_cast<int*>(mask_out), cap, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
