// Mark phase of the exact merge: addMark/removeMark ops applied to the
// boundary bitsets in op order, one thread block per replica -- or, past
// what one block's shared memory holds, one thread-block cluster per
// replica.
//
// Replaces: peritext_tpu/ops/pallas_kernels.py, _mark_kernel (entry
// mark_phase_pallas), and with pt_mark_tail the rest of the composite's
// tail, merge_step_pallas_full's boundary permute (:619) and mark-table
// append (_update_mark_table, :636).  Semantics follow
// kernels._apply_mark_fast (peritext_tpu/ops/kernels.py).  Per op:
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
// The tail form (pt_mark_tail, the merge's): the planes come in as they
// were before the text phase, with its orig_idx [R, C].  Output slot p takes
// input slot 2 * orig_idx[p / 2] + p % 2, row and definedness, or a zero
// row and no definedness where orig_idx is -1 (an element this batch
// inserted) -- kernels._permute_boundaries over all 2C slots, done as the
// entry copy, so the planes are still read once and written once.  Then
// each mark row with m < M writes its id, action, type and attr into
// column m of the table (copied in at entry; rows past M drop, as the
// scatter of _update_mark_table drops them), and the final m is the new
// mark_count.  In the cluster form a block's source rows may lie in
// another block's slice: they come from the input plane, which no block
// writes, and only rank 0 writes the table.
//
// What bounds it on an H100: bytes.  The [2C, W] mask plane of one replica
// is 2 * C * W * 4 bytes -- 512 KiB at C = 2048, W = 32 -- far over the
// 227 KB of shared memory a block may use, so it stays in device memory.
// The kernel's output is a new plane, so the whole plane is read once and
// written once (copied or gathered at entry, then updated in place); at
// R = 1024 that is 1 GiB of traffic, which sets the least time.  Rows move
// in 16-byte units where W * 4 and the alignment allow (128 B at W = 32,
// 16 B at W = 4).  On top of it sits the op-serial chain: per op two
// block-wide reductions and one barrier to publish the carry rows.
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
//
// The cluster form (16384 < C <= 131072): a replica runs on a cluster of S
// = 2, 4 or 8 blocks (the wrapper's choice, the fewest that fit); block
// rank k holds elements [k * C / S, (k + 1) * C / S) and their boundary
// slots, the same 10 bytes an element, and copies and updates only its own
// rows of the mask plane.  Every block runs the op chain in lockstep with
// `m` and the anchors replicated.  Per op, as the explicit sequence-parallel
// merge of peritext_tpu/parallel/shard.py does across devices:
//   - first_match of the start and end elements: a local search, then a
//     cluster-wide min (its pmin);
//   - each carry row's source, the nearest defined slot at or left of an
//     anchor: a local scan, then a cluster-wide max over the blocks'
//     candidates (its all_gather of per-shard summaries, reduced);
//   - the block that holds an anchor slot reads its carry row from device
//     memory (through L2: another block may have written it), then a
//     cluster barrier, so every carry row is read before any block writes;
//   - the column bits and the anchor rows: each block writes only its own
//     slots.
// So a mark op costs three cluster barriers.

#include "common.cuh"

namespace {

using namespace pt;

// The tail form's extra inputs and outputs; all null (and table_cap 0) for
// the plain mark phase.
struct Tail {
  const int* orig_idx;  // [R, C]; null: the planes are copied as they are
  const int* table_in[5];  // mark_ctr, mark_act, mark_action, mark_type, mark_attr [R, M]
  int* table_out[5];
  int* count_out;  // [R]
  int table_cap;   // M
};

// Rows in flight per thread in gather_rows: the loads of a batch are all
// issued before its stores, so a thread waits on device memory once per
// batch, not once per row (with one 512-thread block per SM at C = 16384,
// a row at a time left the gather latency-bound).
constexpr int GATHER_BATCH = 8;

// Output row p of ``rows`` rows, a row being ``units`` values of T, is input
// row 2 * oi[p / 2] + p % 2 and its definedness byte, or a zero row and 0
// where that element is -1 (or out of range).  ``oi`` is in shared memory.
// Rows are spread over the block, ``units`` threads (at most the block) to
// a row, so a warp moves whole neighbouring rows; the threads of unit 0
// move the definedness bytes.
template <typename T>
__device__ __forceinline__ void gather_rows(const T* __restrict__ src, T* __restrict__ dst,
                                            const uint8_t* __restrict__ def_src, uint8_t* def_dst,
                                            const int* oi, int rows, int units, int cap) {
  const int per_row = min(units, static_cast<int>(blockDim.x));
  const int rows_at_once = blockDim.x / per_row;
  const int first = threadIdx.x / per_row;
  if (first >= rows_at_once) return;
  const T zero{};
  for (int u = threadIdx.x % per_row; u < units; u += per_row) {
    for (int p0 = first; p0 < rows; p0 += GATHER_BATCH * rows_at_once) {
      T v[GATHER_BATCH];
      uint8_t d[GATHER_BATCH];
#pragma unroll
      for (int k = 0; k < GATHER_BATCH; ++k) {
        const int p = p0 + k * rows_at_once;
        const int e = p < rows ? oi[p >> 1] : -1;
        const bool live = e >= 0 && e < cap;
        const size_t from = 2 * static_cast<size_t>(live ? e : 0) + (p & 1);
        v[k] = live ? __ldg(src + from * units + u) : zero;
        d[k] = live && u == 0 ? __ldg(def_src + from) : 0;
      }
#pragma unroll
      for (int k = 0; k < GATHER_BATCH; ++k) {
        const int p = p0 + k * rows_at_once;
        if (p < rows) {
          dst[static_cast<size_t>(p) * units + u] = v[k];
          if (u == 0) def_dst[p] = d[k] != 0;
        }
      }
    }
  }
}

// One replica per block (CLUSTER false), or per cluster (CLUSTER true:
// block rank k of the cluster holds elements [k * cs, (k + 1) * cs) and
// slots [2 * k * cs, 2 * (k + 1) * cs), cs = C / S).  Element and slot
// positions are global in both forms; shared arrays are indexed from the
// block's first.
template <bool CLUSTER = false>
__global__ void __launch_bounds__(THREADS) mark_phase_kernel(
    const uint8_t* __restrict__ def_in, const int* mask_in,
    const int* __restrict__ ec_in, const int* __restrict__ ea_in,
    const int* __restrict__ len_in, const int* __restrict__ mc_in,
    const int* __restrict__ ops, int num_ops, uint8_t* __restrict__ def_out,
    int* mask_out, int cap, int words, Tail tail) {
  extern __shared__ int smem[];
  int nblk = 1, rank = 0;
  if constexpr (CLUSTER) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    nblk = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const int cs = cap / nblk;  // elements this block holds, from e0
  const int e0 = rank * cs;
  const int s0 = 2 * e0;      // its slots: [s0, s0 + 2 * cs)
  const int two_c = 2 * cap;
  int* ec = smem;
  int* ea = ec + cs;
  int* row_s = ea + cs;
  int* row_e = row_s + words;
  int* scratch = row_e + words;
  // Cluster form only: two cluster_min2 areas.
  int* cslots = scratch + SCRATCH_INTS;  // [2][2 * MAX_CLUSTER]
  uint8_t* def = reinterpret_cast<uint8_t*>(scratch + SCRATCH_INTS + (CLUSTER ? 4 * MAX_CLUSTER : 0));

  const int r = blockIdx.x / nblk;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t plane = static_cast<size_t>(two_c) * words;
  const size_t slice = static_cast<size_t>(2 * cs) * words;  // this block's rows
  int* mask = mask_out + r * plane;
  const uint8_t* def_r = def_in + static_cast<size_t>(r) * two_c;
  // The tail form (count_out is set even for an empty table, M = 0).
  const bool table = tail.count_out != nullptr && rank == 0;

  if (tail.orig_idx != nullptr) {
    // The boundary permute: this block's slots from anywhere in the input
    // plane (never from mask_out, which other blocks are writing).  Its
    // elements' orig_idx wait in ec's shared memory until the rows move.
    const int* oi = tail.orig_idx + static_cast<size_t>(r) * cap + e0;
    for (int p = tid; p < cs; p += nt) ec[p] = __ldg(oi + p);
    __syncthreads();
    const int* src = mask_in + r * plane;
    int* dst = mask + s0 * static_cast<size_t>(words);
    const uintptr_t both = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
    if (words == 0) {  // M = 0: no mask rows, only the definedness bytes move
      for (int p = tid; p < 2 * cs; p += nt) {
        const int e = ec[p >> 1];
        def[p] = e >= 0 && e < cap && def_r[2 * static_cast<size_t>(e) + (p & 1)] != 0;
      }
    } else if (words % 4 == 0 && both % 16 == 0) {
      gather_rows(reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(dst), def_r, def, ec, 2 * cs,
                  words / 4, cap);
    } else {
      gather_rows(src, dst, def_r, def, ec, 2 * cs, words, cap);
    }
    __syncthreads();  // every orig_idx is read before ec takes the ids
  } else {
    if (mask_in != mask_out) {
      const int* src = mask_in + r * plane + s0 * static_cast<size_t>(words);
      int* dst = mask + s0 * static_cast<size_t>(words);
      const uintptr_t both = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
      if (slice % 4 == 0 && both % 16 == 0) {
        const int4* s4 = reinterpret_cast<const int4*>(src);
        int4* d4 = reinterpret_cast<int4*>(dst);
        for (size_t i = tid; i < slice / 4; i += nt) d4[i] = s4[i];
      } else {
        for (size_t i = tid; i < slice; i += nt) dst[i] = src[i];
      }
    }
    for (int p = tid; p < 2 * cs; p += nt) def[p] = def_r[s0 + p] != 0;
  }
  if (table) {
    const size_t at = static_cast<size_t>(r) * tail.table_cap;
    for (int f = 0; f < 5; ++f) {
      for (int j = tid; j < tail.table_cap; j += nt) tail.table_out[f][at + j] = tail.table_in[f][at + j];
    }
  }
  for (int p = tid; p < cs; p += nt) {
    ec[p] = ec_in[static_cast<size_t>(r) * cap + e0 + p];
    ea[p] = ea_in[static_cast<size_t>(r) * cap + e0 + p];
  }
  const int length = len_in[r];
  const int live_slots = 2 * length;
  const int big = two_c + 2;
  int m = mc_in[r];
  // Elements [e0, e_end) are live; slots [s0, s_end) lie in the defined zone.
  const int e_end = min(min(length, cap), e0 + cs);
  const int s_end = min(min(two_c, live_slots), s0 + 2 * cs);
  // Every block's rows are copied before any block reads a carry row, and
  // the table before thread 0 appends to it.
  if constexpr (CLUSTER) {
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }

  const int* rops = ops + static_cast<size_t>(r) * num_ops * OP_FIELDS;
  for (int l = 0; l < num_ops; ++l) {
    const int* op = rops + l * OP_FIELDS;
    if (op[K_KIND] != KIND_MARK) continue;  // uniform per replica

    // Anchors: first live match of each, 0 when absent.
    const int sctr = op[K_SCTR], sact = op[K_SACT];
    const int ectr = op[K_ECTR], eact = op[K_EACT];
    int fs = cap, fe = cap;
    for (int p = e0 + tid; p < e_end; p += nt) {
      const int c = ec[p - e0], a = ea[p - e0];
      if (c == sctr && a == sact && p < fs) fs = p;
      if (c == ectr && a == eact && p < fe) fe = p;
    }
    block_min2(fs, fe, scratch);
    if constexpr (CLUSTER) cluster_min2(fs, fe, cslots);
    const int s_slot = 2 * (fs == cap ? 0 : fs) + op[K_SKIND];
    const int ekind = op[K_EKIND];
    int e_slot = ekind == 2 ? big : 2 * (fe == cap ? 0 : fe) + (ekind < 1 ? ekind : 1);
    if (e_slot == s_slot) e_slot = big;
    const int e_clamped = e_slot < two_c - 1 ? e_slot : two_c - 1;

    // Carry sources: nearest defined slot at or left of s and of e.
    int src_s = -1, src_e = -1;
    for (int p = s0 + tid; p < s_end; p += nt) {
      if (def[p - s0]) {
        if (p <= s_slot) src_s = p;
        if (p <= e_clamped) src_e = p;
      }
    }
    block_max2(src_s, src_e, scratch);
    if constexpr (CLUSTER) {
      src_s = -src_s;
      src_e = -src_e;
      cluster_min2(src_s, src_e, cslots + 2 * MAX_CLUSTER);
      src_s = -src_s;
      src_e = -src_e;
    }
    // The three write classes touch disjoint words: (s, e), s, e; each
    // block writes those of its own slots.
    const int word = m >> 5;
    const unsigned bit = 1u << (m & 31);
    const bool write_s = s_slot < e_slot && s_slot >= s0 && s_slot < s0 + 2 * cs;
    const bool write_e = e_slot < two_c && e_slot >= s0 && e_slot < s0 + 2 * cs;
    if constexpr (CLUSTER) {
      // Only a block that writes an anchor row reads its carry row, through
      // L2 (another block may have written it), and every block has read
      // before any block writes.
      for (int w = tid; write_s && w < words; w += nt) {
        row_s[w] = src_s >= 0 ? __ldcg(mask + static_cast<size_t>(src_s) * words + w) : 0;
      }
      for (int w = tid; write_e && w < words; w += nt) {
        row_e[w] = src_e >= 0 ? __ldcg(mask + static_cast<size_t>(src_e) * words + w) : 0;
      }
      cooperative_groups::this_cluster().sync();
    } else {
      for (int w = tid; w < words; w += nt) {
        row_s[w] = src_s >= 0 ? mask[static_cast<size_t>(src_s) * words + w] : 0;
        row_e[w] = src_e >= 0 ? mask[static_cast<size_t>(src_e) * words + w] : 0;
      }
      __syncthreads();
    }

    if (s_slot < e_slot) {
      if (word < words) {
        const int hi = min(e_slot, s_end);
        for (int p = max(s_slot + 1, s0) + tid; p < hi; p += nt) {
          if (def[p - s0]) {
            int* cell = mask + static_cast<size_t>(p) * words + word;
            *cell = static_cast<int>(static_cast<unsigned>(*cell) | bit);
          }
        }
      }
    }
    if (write_s) {
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
      if (write_s) def[s_slot - s0] = 1;
      if (write_e) def[e_slot - s0] = 1;
      if (table && static_cast<unsigned>(m) < static_cast<unsigned>(tail.table_cap)) {
        const size_t at = static_cast<size_t>(r) * tail.table_cap + m;
        const int fields[5] = {K_CTR, K_ACT, K_MACTION, K_MTYPE, K_MATTR};
#pragma unroll
        for (int f = 0; f < 5; ++f) tail.table_out[f][at] = op[fields[f]];
      }
    }
    ++m;
    __syncthreads();
  }

  for (int p = tid; p < 2 * cs; p += nt) {
    def_out[static_cast<size_t>(r) * two_c + s0 + p] = static_cast<uint8_t>(def[p]);
  }
  if (table && tid == 0) tail.count_out[r] = m;
  // No block leaves while another may still write into its cluster_min2
  // areas.
  if constexpr (CLUSTER) cooperative_groups::this_cluster().sync();
}

// Shared memory of one block holding ``cap / blocks`` elements; a
// cluster's block adds two areas of cluster_min2 slots.
size_t smem_bytes(int cap, int words, int blocks) {
  const size_t cs = static_cast<size_t>(cap / blocks);
  return (2 * cs + 2 * static_cast<size_t>(words) + SCRATCH_INTS +
          (blocks > 1 ? 4 * MAX_CLUSTER : 0)) * sizeof(int) +
         2 * cs;
}

// The cluster form takes 2, 4 or 8 blocks that split C evenly.
bool cluster_shape_ok(int cap, int blocks) {
  return (blocks == 2 || blocks == 4 || blocks == 8) && cap % blocks == 0;
}

}  // namespace

extern "C" size_t pt_mark_phase_smem(int cap, int words, int blocks) {
  return smem_bytes(cap, words, blocks);
}

// Clusters of ``blocks`` blocks at capacity ``cap`` and ``words`` mask words
// the card can hold at once (cudaOccupancyMaxActiveClusters) into
// ``count``; returns the CUDA error code (0 on success).
extern "C" int pt_mark_phase_max_clusters(int cap, int words, int blocks, int* count) {
  *count = 0;
  if (!cluster_shape_ok(cap, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(cap, words, blocks);
  cudaError_t err = cudaFuncSetAttribute(
      mark_phase_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch cl(1, blocks, THREADS, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, mark_phase_kernel<true>, &cl.config));
}

namespace {

// Launches the mark kernel on ``stream``: one block per replica when
// ``blocks`` is 1, else a cluster of ``blocks`` blocks per replica; returns
// the CUDA error code of the launch (0 on success).
int launch(const void* def_in, const void* mask_in, const void* ec_in, const void* ea_in,
           const void* len_in, const void* mc_in, const void* ops, int num_ops, void* def_out,
           void* mask_out, int replicas, int cap, int words, const Tail& tail, int blocks,
           void* stream) {
  if (replicas == 0) return 0;
  if (blocks != 1 && !cluster_shape_ok(cap, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(cap, words, blocks);
  const auto kernel = blocks == 1 ? mark_phase_kernel<false> : mark_phase_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* d_in = static_cast<const uint8_t*>(def_in);
  const auto* m_in = static_cast<const int*>(mask_in);
  const auto* c_in = static_cast<const int*>(ec_in);
  const auto* a_in = static_cast<const int*>(ea_in);
  const auto* l_in = static_cast<const int*>(len_in);
  const auto* n_in = static_cast<const int*>(mc_in);
  const auto* o_in = static_cast<const int*>(ops);
  auto* d_out = static_cast<uint8_t*>(def_out);
  auto* m_out = static_cast<int*>(mask_out);
  if (blocks == 1) {
    mark_phase_kernel<false><<<replicas, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        d_in, m_in, c_in, a_in, l_in, n_in, o_in, num_ops, d_out, m_out, cap, words, tail);
  } else {
    ClusterLaunch cl(replicas, blocks, THREADS, smem, static_cast<cudaStream_t>(stream));
    err = cudaLaunchKernelEx(&cl.config, mark_phase_kernel<true>, d_in, m_in, c_in, a_in, l_in,
                             n_in, o_in, num_ops, d_out, m_out, cap, words, tail);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The mark phase alone.  Planes: def [R, 2C] uint8, mask [R, 2C, W] int32
// (mask_out may equal mask_in for an in-place update), element ids [R, C],
// length and mark count [R], ops [R, L, 15].
extern "C" int pt_mark_phase(
    const void* def_in, const void* mask_in, const void* ec_in, const void* ea_in,
    const void* len_in, const void* mc_in, const void* ops, int num_ops,
    void* def_out, void* mask_out, int replicas, int cap, int words, int blocks,
    void* stream) {
  const Tail none = {};
  return launch(def_in, mask_in, ec_in, ea_in, len_in, mc_in, ops, num_ops, def_out, mask_out,
                replicas, cap, words, none, blocks, stream);
}

// The merge's tail after its text phase: the planes as they were before it
// (def_in, mask_in), gathered through its orig_idx [R, C] as they load, its
// element ids and length, the mark rows applied, and the five table
// columns [R, M] (M = ``table_cap``) and mark_count appended to.  Every
// output is a tensor of its own: a gather cannot run in place, so an
// output plane equal to its input is refused (cudaErrorInvalidValue).
extern "C" int pt_mark_tail(
    const void* def_in, const void* mask_in, const void* ec_in, const void* ea_in,
    const void* len_in, const void* mc_in, const void* ops, int num_ops, const void* orig_idx,
    const void* ctr_in, const void* act_in, const void* action_in, const void* type_in,
    const void* attr_in, void* def_out, void* mask_out, void* ctr_out, void* act_out,
    void* action_out, void* type_out, void* attr_out, void* count_out, int replicas, int cap,
    int words, int table_cap, int blocks, void* stream) {
  // An empty plane (R, C or W zero) has no address: only two planes at one
  // real address are a gather in place.
  const bool in_place = (mask_in != nullptr && mask_in == mask_out) || (def_in != nullptr && def_in == def_out);
  if (in_place || (orig_idx == nullptr && replicas > 0 && cap > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tail tail = {
      static_cast<const int*>(orig_idx),
      {static_cast<const int*>(ctr_in), static_cast<const int*>(act_in),
       static_cast<const int*>(action_in), static_cast<const int*>(type_in),
       static_cast<const int*>(attr_in)},
      {static_cast<int*>(ctr_out), static_cast<int*>(act_out), static_cast<int*>(action_out),
       static_cast<int*>(type_out), static_cast<int*>(attr_out)},
      static_cast<int*>(count_out),
      table_cap,
  };
  return launch(def_in, mask_in, ec_in, ea_in, len_in, mc_in, ops, num_ops, def_out, mask_out,
                replicas, cap, words, tail, blocks, stream);
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
