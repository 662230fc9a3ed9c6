// Text phase of the exact merge: RGA inserts, fused insert runs and deletes,
// applied in op order, one thread block per replica -- or, past what one
// block's shared memory holds, one thread-block cluster per replica.
//
// Replaces: peritext_tpu/ops/pallas_kernels.py, _text_kernel (entry
// text_phase_pallas).  Semantics follow kernels._apply_text_op /
// _rga_insert_position (peritext_tpu/ops/kernels.py), which is what the JAX
// universe runs: an insert whose reference element is absent goes after
// element 0 (argmax over all-False), where the Pallas kernel drops it.
//
// What bounds it on an H100: the bytes are small -- per replica the element
// ids, tombstones and chars are read once and five planes written once, 53
// KiB at C = 2048.  The time goes to the op-serial chain inside a block: a
// replica's ops cannot overlap, so every op pays its latency in full.  On
// the benchmark's batches nearly every text row is a delete, and a few are
// inserts of a handful of characters; the chain is per-op fixed cost.
//
// What the design does about it:
//   - The op rows' six chain fields (kind, ids, reference, run length) are
//     staged into shared memory in tiles by cp.async, double-buffered: the
//     next tile streams in while this one runs, so no op on the chain waits
//     on device memory.  One barrier per tile.
//   - At each tile's start every warp classifies the tile's rows with
//     ballots (insert rows, delete rows: one bit each), so the row loop
//     jumps from one insert to the next without scanning rows one by one.
//   - A maximal run of rows that insert nothing (deletes and pads) is one
//     pass: deletes neither move an element nor change the length, so they
//     commute.  The run's targets go into a hash table in shared memory
//     (open addressing at load <= 1/4, slots tagged with the pass number so
//     the table never needs clearing), then every live element probes it
//     and is tombstoned on a hit.  One barrier per run, not one per row.
//   - Per slot the block keeps only what the serial chain reads -- the
//     element id (ctr, act) as one 8-byte word -- plus one 4-byte source
//     word: bit 31 the tombstone, the rest the slot's origin (its input
//     position, or C + 64 * op row + offset for an inserted element).  An
//     insert shifts 12 bytes per slot instead of 24; chars and orig_idx are
//     resolved from the source word once, in the epilogue.  Actor ranks are
//     looked up through the read-only cache only when two counters tie.
//   - Only the slots the ops can reach live in shared memory: the prefix
//     [0, phys), at first the live elements.  Every slot past it holds the
//     input slot `shift` places to its left (an insert shifts the whole
//     tail by k), so the epilogue copies the tail from the input planes and
//     an insert moves [t, phys) only -- about half the plane at the
//     benchmark's fill.
//   - The reference find is one block-wide min (one barrier).  The RGA stop
//     is searched by every warp redundantly over a 128-slot window past the
//     reference with ballots -- no barrier -- and only a skip run longer
//     than the window falls back to a block-wide min.  The shift moves up
//     to NT * 8 slots per barrier, held in registers.
//   - Plane loads and stores move four slots per thread as 16-byte words
//     (the tombstones as one 4-byte word) where C and the planes' alignment
//     allow, so fewer, wider requests carry the bytes.
// Shared memory is 12 * C bytes plus the tiles and tables: C = 2048 takes
// 27,904 bytes (eight blocks of 128 threads per SM, so 1024 replicas run in
// one wave) and C = 16384 takes 209,152 bytes; C = 32768 does not fit one
// block.
//
// The cluster form (16384 < C <= 131072): a replica runs on a cluster of S
// = 2, 4 or 8 blocks (the wrapper's choice, the fewest that fit), and block
// rank k holds slots [k * C / S, (k + 1) * C / S) -- the same 12 bytes a
// slot, so at most what C = 16384 takes in one block, plus a halo of
// MAX_RUN_LEN slots.  Every block runs the whole op chain in lockstep,
// stages the op tiles itself and keeps `length`, `phys` and `shift`
// replicated; it reads and writes only its own slots.  What crosses blocks
// goes through distributed shared memory, as the explicit sequence-parallel
// merge of peritext_tpu/parallel/shard.py does across devices:
//   - the reference find and the RGA stop are a local search, then a
//     cluster-wide min (its pmin over the `seq` ring);
//   - an insert of k <= MAX_RUN_LEN elements first writes every block's
//     last k slots into the next block's halo, then one cluster barrier,
//     then each block shifts its own slots and takes the halo in at its
//     head (its ppermute halo exchange);
//   - a delete run needs no exchange: every block builds the run's table
//     from the same tile and probes its own slots.
// So an insert costs three cluster barriers and a delete run none.  With S
// = 1 (the template's one-block instantiation) the slice is the plane and
// every cluster step compiles away.

#include "common.cuh"

namespace {

using namespace pt;

// Staged op-row fields: K_KIND .. K_REF_ACT, then K_RUN_LEN at T_RUN_LEN.
constexpr int KIND_PAD = 0;
constexpr int TILE_FIELDS = 6;
constexpr int T_RUN_LEN = 5;
constexpr unsigned DEAD = 0x80000000u;  // tombstone bit of a source word
constexpr int UNROLL = 4;               // slots per thread per find/probe step
constexpr int SHIFT_ITEMS = 8;          // slots per thread per shift chunk
constexpr int STOP_WINDOW = 4;          // warp-scanned 32-slot chunks past the reference
constexpr int SCRATCH = 32;             // ints per reduction area (one per warp)

// Op rows per staged tile (at most 128: four ballot words); the hash
// table has 4 * tile slots.
__host__ __device__ constexpr int tile_rows(int cap) { return cap <= 4096 ? 32 : 128; }

// Threads per block, C / 16 from 128 to 1024: shared memory holds eight
// blocks per SM at C = 2048, four at 4096, two at 8192 and one at 16384, so
// each SM runs 1024 threads.  Fastest or within 4% of it at every capacity
// on both inputs of bench/text_block_sweep.py (PERF.md).
__host__ __device__ constexpr int threads_for(int cap) {
  return cap <= 2048 ? 128 : cap <= 4096 ? 256 : cap <= 8192 ? 512 : 1024;
}

// The cluster form's block size: its slices are over 8192 slots.
constexpr int CLUSTER_THREADS = 1024;

// Shared memory of one block holding ``cap / blocks`` slots; a cluster's
// block adds the halo (MAX_RUN_LEN ids and source words) and two areas of
// cluster_min2 slots.
__host__ __device__ constexpr size_t smem_bytes(int cap, int blocks = 1) {
  return 12 * static_cast<size_t>(cap / blocks) +
         static_cast<size_t>(tile_rows(cap / blocks)) * (2 * TILE_FIELDS * 4 + 4 * 12) +
         2 * SCRATCH * 4 +
         (blocks > 1 ? MAX_RUN_LEN * 12 + 2 * 2 * MAX_CLUSTER * 4 : 0);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the staged fields of rows [row0, row0 + rows) into dst.
template <int NT>
__device__ __forceinline__ void stage_tile(int* dst, const int* rops, int row0, int rows) {
  for (int i = threadIdx.x; i < rows * TILE_FIELDS; i += NT) {
    const int row = i / TILE_FIELDS;
    const int f = i - row * TILE_FIELDS;
    cp_async4(dst + i, rops + static_cast<size_t>(row0 + row) * OP_FIELDS + (f == T_RUN_LEN ? K_RUN_LEN : f));
  }
  cp_async_commit();
}

// Block-wide min with one barrier.  The caller guarantees another barrier
// before the same scratch area is written again.
template <int NT>
__device__ __forceinline__ int block_min_once(int v, int* scratch) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = INT_MAX;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) m = min(m, scratch[w]);
  return m;
}

// The min over a replica's blocks: block-wide, then in the cluster form
// cluster-wide through ``cslots`` (a cluster_min2 area).
template <int NT, bool CLUSTER>
__device__ __forceinline__ int replica_min(int v, int* scratch, int* cslots) {
  v = block_min_once<NT>(v, scratch);
  if constexpr (CLUSTER) {
    int unused = INT_MAX;
    cluster_min2(v, unused, cslots);
  }
  return v;
}

// Multiplicative hash: the top `bits` bits of the mixed id.
__device__ __forceinline__ unsigned slot_hash(int c, int a, int bits) {
  return (static_cast<unsigned>(c) * 0x9E3779B1u + static_cast<unsigned>(a) * 0x85EBCA77u) >>
         (32 - bits);
}

// First row >= i whose bit is set in the tile's ballot words, else `rows`
// (the words stay in registers: every index is a constant).
__device__ __forceinline__ int next_row(const unsigned (&mask)[4], int i, int rows) {
  int first = rows;
#pragma unroll
  for (int w = 3; w >= 0; --w) {
    unsigned m = mask[w];
    if (i >= 32 * w + 32) {
      m = 0;
    } else if (i > 32 * w) {
      m &= ~0u << (i - 32 * w);
    }
    if (m) first = 32 * w + __ffs(m) - 1;
  }
  return min(first, rows);
}

// Any bit set in [i, j) of the tile's ballot words?
__device__ __forceinline__ bool any_row(const unsigned (&mask)[4], int i, int j) {
  return next_row(mask, i, j) < j;
}

// Does the element order after the inserted one (RGA skip rule)?
__device__ __forceinline__ bool greater(int2 e, int ctr, int op_rank, const int* __restrict__ ranks,
                                        int num_ranks) {
  return e.x > ctr || (e.x == ctr && __ldg(ranks + clampi(e.y, 0, num_ranks - 1)) > op_rank);
}

// Slots [bottom, top) of a block take the slot k to their left, top down,
// NT * SHIFT_ITEMS slots per barrier.  A chunk reads below its own
// destination range, so it never reads what a higher chunk wrote; the next
// lower chunk writes only after its own barrier, which no thread passes
// before every thread has finished this chunk's reads.  Returns whether any
// chunk ran (and so passed a barrier).
template <int NT>
__device__ __forceinline__ bool shift_right(int2* id, unsigned* src, int bottom, int top, int k) {
  bool moved = false;
  for (; k > 0 && top > bottom; top -= NT * SHIFT_ITEMS) {
    int2 v[SHIFT_ITEMS];
    unsigned s[SHIFT_ITEMS];
#pragma unroll
    for (int u = 0; u < SHIFT_ITEMS; ++u) {
      const int p = top - 1 - threadIdx.x - u * NT;
      if (p >= bottom) {
        v[u] = id[p - k];
        s[u] = src[p - k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SHIFT_ITEMS; ++u) {
      const int p = top - 1 - threadIdx.x - u * NT;
      if (p >= bottom) {
        id[p] = v[u];
        src[p] = s[u];
      }
    }
    moved = true;
  }
  return moved;
}

// One replica per block (CLUSTER false), or per cluster of gridDim-aligned
// blocks (CLUSTER true: block rank k of the cluster holds slots
// [k * cs, (k + 1) * cs), cs = C / S).  Positions, `length`, `phys` and
// `shift` are global slot indices in both forms; a block's shared arrays
// are indexed by slot - lo.
template <int NT, bool CLUSTER = false>
__global__ void __launch_bounds__(NT, 1024 / NT) text_phase_kernel(
    const int* __restrict__ ec_in, const int* __restrict__ ea_in,
    const uint8_t* __restrict__ dl_in, const int* __restrict__ ch_in,
    const int* __restrict__ len_in, const int* __restrict__ ops, int num_ops,
    const int* __restrict__ ranks, int num_ranks,
    const int* __restrict__ char_buf, int buf_len,
    int* __restrict__ ec_out, int* __restrict__ ea_out,
    uint8_t* __restrict__ dl_out, int* __restrict__ ch_out,
    int* __restrict__ oi_out, int* __restrict__ len_out, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  int nblk = 1, rank = 0;
  if constexpr (CLUSTER) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    nblk = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const int cs = cap / nblk;  // slots this block holds: [lo, hi)
  const int lo = rank * cs;
  const int hi = lo + cs;
  const int tile = tile_rows(cs);
  const int tsize = 4 * tile;  // hash slots, a power of two
  const int tbits = __ffs(tsize) - 1;
  int2* id = reinterpret_cast<int2*>(smem);               // [cs] (ctr, act)
  int2* tkey = id + cs;                                   // [tsize]
  unsigned* src = reinterpret_cast<unsigned*>(tkey + tsize);  // [cs]
  int* tiles = reinterpret_cast<int*>(src + cs);          // [2][tile * TILE_FIELDS]
  int* ttag = tiles + 2 * tile * TILE_FIELDS;             // [tsize]
  int* scratch = ttag + tsize;                            // [2][SCRATCH]
  // Cluster form only: the halo the previous block writes (ids and source
  // words of its last MAX_RUN_LEN slots) and two cluster_min2 areas.
  int2* halo_id = reinterpret_cast<int2*>(scratch + 2 * SCRATCH);  // [MAX_RUN_LEN]
  unsigned* halo_src = reinterpret_cast<unsigned*>(halo_id + MAX_RUN_LEN);  // [MAX_RUN_LEN]
  int* cslots = reinterpret_cast<int*>(halo_src + MAX_RUN_LEN);    // [2][2 * MAX_CLUSTER]

  const int r = blockIdx.x / nblk;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(r) * cap;
  const size_t sbase = base + lo;  // this block's slice of the row
  const int* rops = ops + static_cast<size_t>(r) * num_ops * OP_FIELDS;
  const int ntiles = (num_ops + tile - 1) / tile;
  if (ntiles > 0) stage_tile<NT>(tiles, rops, 0, min(tile, num_ops));

  // Groups of four slots move as 16-byte words (their tombstones as one
  // 4-byte word) when the slice and every plane's alignment allow it.
  const bool vec = cs % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(ec_in) | reinterpret_cast<uintptr_t>(ea_in) |
                    reinterpret_cast<uintptr_t>(ch_in) | reinterpret_cast<uintptr_t>(ec_out) |
                    reinterpret_cast<uintptr_t>(ea_out) | reinterpret_cast<uintptr_t>(ch_out) |
                    reinterpret_cast<uintptr_t>(oi_out)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(dl_in) | reinterpret_cast<uintptr_t>(dl_out)) % 4 == 0;
  int length = len_in[r];
  int phys = min(max(length, 0), cap);  // slots [0, phys) are held in shared memory
  int shift = 0;                        // slot q >= phys holds input slot q - shift
  const int held = clampi(phys - lo, 0, cs);
  const int held4 = vec ? held / 4 : 0;
  for (int g = tid; g < held4; g += NT) {
    const int4 c = reinterpret_cast<const int4*>(ec_in + sbase)[g];
    const int4 a = reinterpret_cast<const int4*>(ea_in + sbase)[g];
    const unsigned d = reinterpret_cast<const unsigned*>(dl_in + sbase)[g];
    reinterpret_cast<int4*>(id)[2 * g] = make_int4(c.x, a.x, c.y, a.y);
    reinterpret_cast<int4*>(id)[2 * g + 1] = make_int4(c.z, a.z, c.w, a.w);
    const unsigned p = lo + 4 * g;
    reinterpret_cast<uint4*>(src)[g] =
        make_uint4(p | (d & 0xffu ? DEAD : 0u), (p + 1) | (d & 0xff00u ? DEAD : 0u),
                   (p + 2) | (d & 0xff0000u ? DEAD : 0u), (p + 3) | (d & 0xff000000u ? DEAD : 0u));
  }
  for (int p = 4 * held4 + tid; p < held; p += NT) {
    id[p] = make_int2(ec_in[sbase + p], ea_in[sbase + p]);
    src[p] = static_cast<unsigned>(lo + p) | (dl_in[sbase + p] ? DEAD : 0u);
  }
  for (int i = tid; i < tsize; i += NT) ttag[i] = 0;
  // Delete passes so far; pass g tags the slots it fills with g.  Two
  // passes always have a barrier between them (an insert's, or a tile's),
  // so a pass never fills a slot while the last one is still probing.
  int pass = 0;
  bool fenced = true;   // no tombstone write since the last barrier

  for (int ti = 0; ti < ntiles; ++ti) {
    // Tile ti has landed and every thread is done with tile ti - 1, whose
    // buffer now takes tile ti + 1.
    cp_async_wait_all();
    __syncthreads();
    fenced = true;
    const int row0 = ti * tile;
    const int rows = min(tile, num_ops - row0);
    if (ti + 1 < ntiles) {
      stage_tile<NT>(tiles + ((ti + 1) & 1) * tile * TILE_FIELDS, rops, row0 + tile,
                     min(tile, num_ops - row0 - tile));
    }
    const int* trow = tiles + (ti & 1) * tile * TILE_FIELDS;

    // The tile's insert rows and delete rows, one bit each, in every warp.
    unsigned ins_rows[4], del_rows[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int row = 32 * w + (tid & 31);
      const int kind = row < rows ? trow[row * TILE_FIELDS + K_KIND] : KIND_PAD;
      ins_rows[w] = __ballot_sync(0xffffffffu, kind == KIND_INSERT || (kind == KIND_INSERT_RUN && buf_len > 0));
      del_rows[w] = __ballot_sync(0xffffffffu, kind == KIND_DELETE);
    }

    int i = 0;
    while (i < rows) {
      const int* op = trow + i * TILE_FIELDS;
      const int kind = op[K_KIND];
      const bool is_run = kind == KIND_INSERT_RUN && buf_len > 0;
      if (kind != KIND_INSERT && !is_run) {
        // Rows [i, j) insert nothing; their deletes form one pass.
        const int j = next_row(ins_rows, i, rows);
        if (any_row(del_rows, i, j)) {
          ++pass;
          for (int q = i + tid; q < j; q += NT) {
            const int* o = trow + q * TILE_FIELDS;
            if (o[K_KIND] != KIND_DELETE) continue;
            const int c = o[K_REF_CTR], a = o[K_REF_ACT];
            unsigned h = slot_hash(c, a, tbits);
            while (atomicExch(ttag + h, pass) == pass) h = (h + 1) & (tsize - 1);
            tkey[h] = make_int2(c, a);
          }
          __syncthreads();
          const int lim = clampi(min(length, cap) - lo, 0, cs);
          for (int p0 = tid; p0 < lim; p0 += UNROLL * NT) {
            int2 e[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              if (p0 + u * NT < lim) e[u] = id[p0 + u * NT];
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              if (p0 + u * NT >= lim) continue;
              unsigned h = slot_hash(e[u].x, e[u].y, tbits);
              while (ttag[h] == pass) {
                const int2 kv = tkey[h];
                if (kv.x == e[u].x && kv.y == e[u].y) {
                  src[p0 + u * NT] |= DEAD;
                  break;
                }
                h = (h + 1) & (tsize - 1);
              }
            }
          }
          fenced = false;
        }
        i = j;
        continue;
      }

      // One insert or fused run of k elements.
      const int l = row0 + i;
      const int ctr = op[K_CTR];
      const int act = op[K_ACT];
      const int ref_ctr = op[K_REF_CTR];
      const int ref_act = op[K_REF_ACT];
      const int run_len = is_run ? op[T_RUN_LEN] : 1;
      const int lim = clampi(min(length, cap) - lo, 0, cs);

      // Reference element: first live match, 0 when absent, -1 for HEAD.
      int idx = -1;
      if (ref_ctr != 0 || ref_act != 0) {
        int first = cap;
        for (int p0 = tid; p0 < lim && first == cap; p0 += UNROLL * NT) {
          int2 e[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (p0 + u * NT < lim) e[u] = id[p0 + u * NT];
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (first == cap && p0 + u * NT < lim && e[u].x == ref_ctr && e[u].y == ref_act) {
              first = lo + p0 + u * NT;
            }
          }
        }
        first = replica_min<NT, CLUSTER>(first, scratch, cslots);
        idx = first == cap ? 0 : first;
        fenced = true;
      } else if (!fenced) {
        __syncthreads();  // the last pass's tombstones, before the shift reads them
        fenced = true;
      }

      // Stop of the skip run: first p > idx that is dead or has a smaller
      // id; each block searches its own slots from `from` on.
      const int op_rank = __ldg(ranks + clampi(act, 0, num_ranks - 1));
      const int lane = tid & 31;
      const int from = max(idx + 1, lo);
      int t = -1;
#pragma unroll 1
      for (int w = 0; w < STOP_WINDOW; ++w) {
        const int p = from + 32 * w + lane;
        const bool stop = p < hi ? p >= length || !greater(id[p - lo], ctr, op_rank, ranks, num_ranks)
                                 : p >= cap;
        const unsigned hits = __ballot_sync(0xffffffffu, stop);
        if (hits) {
          t = min(cap, from + 32 * w + __ffs(hits) - 1);
          break;
        }
      }
      if (t < 0) {  // a skip run longer than the window: uniform across warps
        if (from + 32 * STOP_WINDOW < hi) {
          int first = cap;
          for (int p = from + 32 * STOP_WINDOW + tid; p < hi; p += NT) {
            if (p >= length || !greater(id[p - lo], ctr, op_rank, ranks, num_ranks)) {
              first = p;
              break;
            }
          }
          t = block_min_once<NT>(first, scratch + SCRATCH);
        } else {
          t = cap;  // no slot of this block past the reference
        }
      }
      if constexpr (CLUSTER) {
        int unused = INT_MAX;
        cluster_min2(t, unused, cslots + 2 * MAX_CLUSTER);
      }

      // t lies past the held prefix only when the reference is absent from
      // an empty document (t = 1): bring the slots in between into it.
      if (t > phys) {
        for (int q = max(phys, lo) + tid; q < min(t, hi); q += NT) {
          const size_t o = base + (q - shift);
          id[q - lo] = make_int2(ec_in[o], ea_in[o]);
          src[q - lo] = static_cast<unsigned>(q - shift) | (dl_in[o] ? DEAD : 0u);
        }
        __syncthreads();
        phys = t;
      }

      // Shift [t, phys) right by k.  (Run lengths are >= 0: the encoder
      // emits 1..MAX_RUN_LEN.)
      const int k = min(max(run_len, 0), cap);
      bool synced;
      if constexpr (CLUSTER) {
        // In steps of at most the halo's MAX_RUN_LEN slots (one step unless
        // a run is longer than the encoder makes them); step s moves [t +
        // moved, phys + moved) right by `step`.  Every block's last `step`
        // slots go to the next block's halo first (it uses those in that
        // range), then a cluster barrier, which also keeps the stop
        // search's cluster_min2 area from the next insert's writes; a
        // second step waits for the halo to be taken in.
        cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
        int moved = 0;
        do {
          const int step = min(k - moved, MAX_RUN_LEN);
          if (moved > 0) cluster.sync();
          if (rank + 1 < nblk) {
            int2* next_id = cluster.map_shared_rank(halo_id, rank + 1);
            unsigned* next_src = cluster.map_shared_rank(halo_src, rank + 1);
            for (int j = tid; j < step; j += NT) {
              next_id[j] = id[cs - step + j];
              next_src[j] = src[cs - step + j];
            }
          }
          cluster.sync();
          const int at = t + moved + step;  // first slot this step writes
          const int top = min(phys + moved + step, hi);
          shift_right<NT>(id, src, max(at, lo + step) - lo, top - lo, step);
          // The head [max(at, lo), lo + step) takes the previous block's
          // slots from the halo.
          for (int p = max(at, lo) + tid; p < min(lo + step, top); p += NT) {
            id[p - lo] = halo_id[p - lo];
            src[p - lo] = halo_src[p - lo];
          }
          moved += step;
        } while (moved < k);
        synced = true;
      } else {
        synced = shift_right<NT>(id, src, t + k, min(phys + k, cap), k);
      }
      if (!synced) __syncthreads();  // every warp is past its stop search

      // The inserted block [t, t + k).
      const int end = min(min(cap, t + k), hi);
      for (int p = max(t, lo) + tid; p < end; p += NT) {
        const int off = p - t;
        id[p - lo] = make_int2(static_cast<int>(static_cast<unsigned>(ctr) + off), act);
        src[p - lo] = static_cast<unsigned>(cap + MAX_RUN_LEN * l + min(off, MAX_RUN_LEN - 1));
      }
      length = static_cast<int>(static_cast<unsigned>(length) + static_cast<unsigned>(run_len));
      const int grown = min(phys + k, cap);
      if (grown < cap) shift += k;  // once the prefix is the whole plane, no tail is left
      phys = grown;
      __syncthreads();
      ++i;
    }
  }

  // Epilogue: held slots from their ids and source words ...
  __syncthreads();
  const int* rbuf = char_buf + static_cast<size_t>(r) * buf_len;
  auto held_char = [&](int from) {
    if (from < cap) return ch_in[base + from];
    const int code = from - cap;
    const int* o = rops + static_cast<size_t>(code / MAX_RUN_LEN) * OP_FIELDS;
    const int payload = __ldg(o + K_PAYLOAD);
    return __ldg(o + K_KIND) == KIND_INSERT_RUN
               ? rbuf[clampi(payload, 0, buf_len - MAX_RUN_LEN) + code % MAX_RUN_LEN]
               : payload;
  };
  const int held_out = clampi(phys - lo, 0, cs);
  const int out4 = vec ? held_out / 4 : 0;
  for (int g = tid; g < out4; g += NT) {
    const int4 e01 = reinterpret_cast<const int4*>(id)[2 * g];
    const int4 e23 = reinterpret_cast<const int4*>(id)[2 * g + 1];
    const uint4 s = reinterpret_cast<const uint4*>(src)[g];
    const int f0 = static_cast<int>(s.x & ~DEAD), f1 = static_cast<int>(s.y & ~DEAD);
    const int f2 = static_cast<int>(s.z & ~DEAD), f3 = static_cast<int>(s.w & ~DEAD);
    int4 ch;
    if (f0 % 4 == 0 && f1 == f0 + 1 && f2 == f0 + 2 && f3 == f0 + 3 && f3 < cap) {
      ch = reinterpret_cast<const int4*>(ch_in + base)[f0 / 4];
    } else {
      ch = make_int4(held_char(f0), held_char(f1), held_char(f2), held_char(f3));
    }
    reinterpret_cast<int4*>(ec_out + sbase)[g] = make_int4(e01.x, e01.z, e23.x, e23.z);
    reinterpret_cast<int4*>(ea_out + sbase)[g] = make_int4(e01.y, e01.w, e23.y, e23.w);
    reinterpret_cast<int4*>(ch_out + sbase)[g] = ch;
    reinterpret_cast<int4*>(oi_out + sbase)[g] =
        make_int4(f0 < cap ? f0 : -1, f1 < cap ? f1 : -1, f2 < cap ? f2 : -1, f3 < cap ? f3 : -1);
    reinterpret_cast<unsigned*>(dl_out + sbase)[g] =
        (s.x >> 31) | (s.y >> 31) << 8 | (s.z >> 31) << 16 | (s.w >> 31) << 24;
  }
  for (int p = 4 * out4 + tid; p < held_out; p += NT) {
    const unsigned s = src[p];
    const int from = static_cast<int>(s & ~DEAD);
    ec_out[sbase + p] = id[p].x;
    ea_out[sbase + p] = id[p].y;
    dl_out[sbase + p] = static_cast<uint8_t>(s >> 31);
    ch_out[sbase + p] = held_char(from);
    oi_out[sbase + p] = from < cap ? from : -1;
  }
  // ... and the tail straight from the input, `shift` slots to the left,
  // in 16-byte words from the first whole group on when `shift` keeps the
  // groups aligned.
  const bool vec_tail = vec && shift % 4 == 0;
  const int tail_from = max(phys, lo);
  const int tail_lo = vec_tail ? min(hi, (tail_from + 3) / 4 * 4) : hi;
  for (int p = tail_from + tid; p < tail_lo; p += NT) {
    const size_t o = base + (p - shift);
    ec_out[base + p] = ec_in[o];
    ea_out[base + p] = ea_in[o];
    dl_out[base + p] = dl_in[o];
    ch_out[base + p] = ch_in[o];
    oi_out[base + p] = p - shift;
  }
  for (int g = tail_lo / 4 + tid; vec_tail && g < hi / 4; g += NT) {
    const int h = g - shift / 4;
    reinterpret_cast<int4*>(ec_out + base)[g] = reinterpret_cast<const int4*>(ec_in + base)[h];
    reinterpret_cast<int4*>(ea_out + base)[g] = reinterpret_cast<const int4*>(ea_in + base)[h];
    reinterpret_cast<int4*>(ch_out + base)[g] = reinterpret_cast<const int4*>(ch_in + base)[h];
    reinterpret_cast<unsigned*>(dl_out + base)[g] = reinterpret_cast<const unsigned*>(dl_in + base)[h];
    reinterpret_cast<int4*>(oi_out + base)[g] = make_int4(4 * h, 4 * h + 1, 4 * h + 2, 4 * h + 3);
  }
  if (tid == 0 && rank == 0) len_out[r] = length;
  // No block leaves while another may still write into its halo or slots.
  if constexpr (CLUSTER) cooperative_groups::this_cluster().sync();
}

template <int NT, bool CLUSTER = false>
cudaError_t set_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(text_phase_kernel<NT, CLUSTER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(text_phase_kernel<NT, CLUSTER>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int NT>
cudaError_t launch(int replicas, int cap, cudaStream_t stream, const int* ec_in, const int* ea_in,
                   const uint8_t* dl_in, const int* ch_in, const int* len_in, const int* ops,
                   int num_ops, const int* ranks, int num_ranks, const int* char_buf, int buf_len,
                   int* ec_out, int* ea_out, uint8_t* dl_out, int* ch_out, int* oi_out,
                   int* len_out) {
  const size_t smem = smem_bytes(cap);
  const cudaError_t err = set_attributes<NT>(smem);
  if (err != cudaSuccess) return err;
  text_phase_kernel<NT><<<replicas, NT, smem, stream>>>(
      ec_in, ea_in, dl_in, ch_in, len_in, ops, num_ops, ranks, num_ranks, char_buf, buf_len,
      ec_out, ea_out, dl_out, ch_out, oi_out, len_out, cap);
  return cudaGetLastError();
}

// The launch at ``threads`` (128, 256, 512 or 1024) per block, on the
// untyped pointers of the C interface.
cudaError_t launch_threads(int threads, const void* ec_in, const void* ea_in, const void* dl_in,
                           const void* ch_in, const void* len_in, const void* ops, int num_ops,
                           const void* ranks, int num_ranks, const void* char_buf, int buf_len,
                           void* ec_out, void* ea_out, void* dl_out, void* ch_out, void* oi_out,
                           void* len_out, int replicas, int cap, void* stream) {
  decltype(&launch<128>) kernel = nullptr;
  switch (threads) {
    case 128: kernel = &launch<128>; break;
    case 256: kernel = &launch<256>; break;
    case 512: kernel = &launch<512>; break;
    case 1024: kernel = &launch<1024>; break;
    default: return cudaErrorInvalidValue;
  }
  return kernel(replicas, cap, static_cast<cudaStream_t>(stream), static_cast<const int*>(ec_in),
                static_cast<const int*>(ea_in), static_cast<const uint8_t*>(dl_in),
                static_cast<const int*>(ch_in), static_cast<const int*>(len_in),
                static_cast<const int*>(ops), num_ops, static_cast<const int*>(ranks), num_ranks,
                static_cast<const int*>(char_buf), buf_len, static_cast<int*>(ec_out),
                static_cast<int*>(ea_out), static_cast<uint8_t*>(dl_out),
                static_cast<int*>(ch_out), static_cast<int*>(oi_out), static_cast<int*>(len_out));
}

// The cluster form takes 2, 4 or 8 blocks that split C into slices of a
// multiple of four slots, each over 8192 slots (where threads_for gives
// CLUSTER_THREADS).
bool cluster_shape_ok(int cap, int blocks) {
  return (blocks == 2 || blocks == 4 || blocks == 8) && cap % (4 * blocks) == 0 &&
         threads_for(cap / blocks) == CLUSTER_THREADS;
}

}  // namespace

extern "C" size_t pt_text_phase_smem(int cap, int blocks) { return smem_bytes(cap, blocks); }

// Clusters of ``blocks`` blocks at capacity ``cap`` the card can hold at
// once (cudaOccupancyMaxActiveClusters) into ``count``; returns the CUDA
// error code (0 on success).
extern "C" int pt_text_phase_max_clusters(int cap, int blocks, int* count) {
  *count = 0;
  if (!cluster_shape_ok(cap, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(cap, blocks);
  cudaError_t err = set_attributes<CLUSTER_THREADS, true>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch cl(1, blocks, CLUSTER_THREADS, smem, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, text_phase_kernel<CLUSTER_THREADS, true>, &cl.config));
}

// Launches the text phase on ``stream``: one block of ``threads_for(cap)``
// threads per replica when ``blocks`` is 1, else a cluster of ``blocks``
// blocks per replica; returns the CUDA error code of the launch (0 on
// success).  Pointers are device pointers of contiguous tensors: planes [R,
// C], ops [R, L, 15], ranks [A], char_buf [R, buf_len] (buf_len 0: no run
// buffer, KIND_INSERT_RUN rows are no-ops).  C + 64 * L must stay below
// 2^31.
extern "C" int pt_text_phase(
    const void* ec_in, const void* ea_in, const void* dl_in, const void* ch_in,
    const void* len_in, const void* ops, int num_ops, const void* ranks,
    int num_ranks, const void* char_buf, int buf_len, void* ec_out,
    void* ea_out, void* dl_out, void* ch_out, void* oi_out, void* len_out,
    int replicas, int cap, int blocks, void* stream) {
  if (replicas == 0) return 0;
  if (blocks == 1) {
    return static_cast<int>(launch_threads(threads_for(cap), ec_in, ea_in, dl_in, ch_in, len_in,
                                           ops, num_ops, ranks, num_ranks, char_buf, buf_len,
                                           ec_out, ea_out, dl_out, ch_out, oi_out, len_out,
                                           replicas, cap, stream));
  }
  if (!cluster_shape_ok(cap, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(cap, blocks);
  cudaError_t err = set_attributes<CLUSTER_THREADS, true>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch cl(replicas, blocks, CLUSTER_THREADS, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cl.config, text_phase_kernel<CLUSTER_THREADS, true>,
                           static_cast<const int*>(ec_in), static_cast<const int*>(ea_in),
                           static_cast<const uint8_t*>(dl_in), static_cast<const int*>(ch_in),
                           static_cast<const int*>(len_in), static_cast<const int*>(ops), num_ops,
                           static_cast<const int*>(ranks), num_ranks,
                           static_cast<const int*>(char_buf), buf_len, static_cast<int*>(ec_out),
                           static_cast<int*>(ea_out), static_cast<uint8_t*>(dl_out),
                           static_cast<int*>(ch_out), static_cast<int*>(oi_out),
                           static_cast<int*>(len_out), cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
