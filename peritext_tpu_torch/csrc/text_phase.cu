// Text phase of the exact merge: RGA inserts, fused insert runs and deletes,
// applied in op order, one thread block per replica -- or, past what one
// block's shared memory holds, one thread-block cluster per replica.  Past
// C = 8192 up to 16384 a third form, the piece form at the end of this
// file, keeps a piece table in place of the planes (see there).
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


// ---------------------------------------------------------------------------
// The piece form (8192 < C <= 16384, wherever the batch's piece table fits a
// quarter of an SM's shared memory; the wrapper decides from C and L alone).
//
// At C = 16384 the plane form above holds 12 bytes a slot in shared memory,
// so one block fills an SM and its op chain -- a block-wide find, shift and
// barrier per insert row, a probe of every live slot per delete pass --
// runs with nothing to hide it.  The piece form keeps no plane in shared
// memory.  The document is a piece table: an ordered array of pieces, each
// a span of input slots or of one row's inserted elements, whose lengths
// always sum to C (what falls past C is dropped, as the plane drops it).
// Shared memory grows with the rows, not with C (47,464 bytes at L = 512,
// so four replicas share an SM; six at L <= 256), and a replica runs in
// three steps:
//
//   1. All threads: every row's reference and delete target go into a hash
//      table of keys in shared memory (at most L keys in 2L or more slots),
//      each key with its last delete row; insert rows are compacted, in row
//      order, into records.  Then one pass over the live input ids, in
//      16-byte words, gives each key its first input slot, and tombstones
//      (a bit a slot) every input slot whose key is deleted.
//   2. One warp runs the insert rows in order, with no block barrier: an
//      insert finds its reference by a ballot over the pieces (an input
//      piece holding the key's first input slot, or an inserted piece
//      holding the id), walks the RGA skip rule from there 32 elements at a
//      time (input ids through the read-only cache, inserted ids computed,
//      ranks read only on a counter tie), splits at most one piece, links
//      its own and drops its length off the end.
//   3. All threads: prefix sums of the piece lengths give every output slot
//      its source, and the five planes are written in one pass over
//      [0, C), in 16-byte words where C and the planes allow; input runs are
//      read in 16-byte words as well, inserted chars from the row or the run
//      buffer.  An inserted element is a tombstone when its key's last
//      delete comes after its row.
//
// The twin's rules carry over as follows.  A delete reaches every live copy
// of its target while it is live; live elements never stop being live but
// by falling past C, so an element left in the output is a tombstone
// exactly when a delete of its id comes after it became live: the output
// needs each key's last delete row, not the order of deletes among inserts.
// Deletes therefore never touch the chain.  A document of length <= 0 has
// no live element (a reference is absent, an insert goes to position 0 or,
// after an absent reference, 1): until the first insert brings the length
// to 1 or more, every piece is marked garbage; at that row the pieces are
// walked once, those below the length become live, and the input slots
// among them are scanned for keys as step 1 scans the live input.
// ---------------------------------------------------------------------------

// 256 threads, registers for six blocks an SM (40 a thread): at R = 4,096 on
// the resident batches 1.12 / 0.92 / 1.22 ms (genesis, round, all-to-all)
// against 1.48 / 1.00 / 1.21 at four, fastest or within 6% of the fastest
// of 128, 256 and 512 threads at 2-16 blocks (PERF.md, Findings).
constexpr int PIECE_THREADS = 256;
constexpr int PIECE_MIN_BLOCKS = 6;
constexpr size_t MAX_BLOCK_SMEM = 232448;  // one block's shared memory on sm_90
constexpr int PIECE_SCRATCH = 64;  // ints: warp counts, then the chain's results
constexpr int PIECE_INSERTED = 1 << 16;  // piece flags, above a 16-bit length
constexpr int PIECE_GARBAGE = 1 << 17;   // never live (past the length)
constexpr unsigned long long NO_KEY = 0x8000000080000000ull;  // (INT_MIN, INT_MIN): an empty slot
constexpr unsigned FULL = 0xffffffffu;

// Hash slots for ``num_ops`` rows: a power of two, at least twice the keys.
__host__ __device__ constexpr int piece_hash_slots(int num_ops) {
  int t = 32;
  while (t < 2 * num_ops) t *= 2;
  return t;
}

// Pieces a batch can make: the live input and the garbage tail, two per
// insert (a split and its own), one more where a length first turns >= 1.
__host__ __device__ constexpr int piece_slots(int num_ops) { return 2 * num_ops + 4; }

// Pieces (16 B), insert records (16 B), key slots and the NO_KEY slot
// (8 B key, 4 B first input slot, 4 B last delete row), tombstone bits a
// slot plus a spare word, the pieces' starts and the scratch.
__host__ __device__ constexpr size_t piece_smem_bytes(int cap, int num_ops) {
  return 16 * static_cast<size_t>(piece_slots(num_ops)) +
         16 * static_cast<size_t>(num_ops > 1 ? num_ops : 1) +
         16 * static_cast<size_t>(piece_hash_slots(num_ops) + 1) +
         4 * static_cast<size_t>((cap + 31) / 32 + 1) +
         4 * static_cast<size_t>(piece_slots(num_ops) + 1) + 4 * PIECE_SCRATCH;
}

__device__ __forceinline__ unsigned long long pack_key(int c, int a) {
  return static_cast<unsigned long long>(static_cast<unsigned>(a)) << 32 | static_cast<unsigned>(c);
}

// Open addressing over ``mask + 1`` slots; the key NO_KEY, which marks an
// empty slot, lives in slot mask + 1 (``key`` there is 1 once it is used).
struct KeyTable {
  unsigned long long* key;
  int* first;     // first input slot holding the key, INT_MAX if none
  int* last_del;  // last delete row of the key, -1 if none
  int bits;
  int mask;

  __device__ int insert(int c, int a) {
    const unsigned long long k = pack_key(c, a);
    if (k == NO_KEY) {
      key[mask + 1] = 1;
      return mask + 1;
    }
    unsigned h = slot_hash(c, a, bits);
    for (;;) {
      const unsigned long long old = atomicCAS(key + h, NO_KEY, k);
      if (old == NO_KEY || old == k) return static_cast<int>(h);
      h = (h + 1) & mask;
    }
  }

  __device__ int find(int c, int a) const {
    const unsigned long long k = pack_key(c, a);
    if (k == NO_KEY) return key[mask + 1] ? mask + 1 : -1;
    unsigned h = slot_hash(c, a, bits);
    for (;;) {
      const unsigned long long s = key[h];
      if (s == k) return static_cast<int>(h);
      if (s == NO_KEY) return -1;
      h = (h + 1) & mask;
    }
  }

  // Input slot j holds (c, a): record it as the key's first slot, and
  // tombstone it when the key is deleted after row ``live_from``.
  __device__ void see_input(int j, int c, int a, int live_from, unsigned* tomb) {
    const int s = find(c, a);
    if (s < 0) return;
    atomicMin(first + s, j);
    if (last_del[s] > live_from) atomicOr(tomb + (j >> 5), 1u << (j & 31));
  }
};

// A piece: x the first input slot, or the row | the row's first element
// offset << 16; y the length | flags; z the id counter of the first element
// (inserted pieces); w its actor.
__device__ __forceinline__ int piece_len(int4 q) { return q.y & 0xffff; }

__device__ __forceinline__ int4 piece_head(int4 q, int o) {  // its first o elements
  return make_int4(q.x, (q.y & ~0xffff) | o, q.z, q.w);
}

__device__ __forceinline__ int4 piece_tail(int4 q, int o) {  // from element o on
  return (q.y & PIECE_INSERTED)
             ? make_int4(q.x + (o << 16), q.y - o, static_cast<int>(static_cast<unsigned>(q.z) + o), q.w)
             : make_int4(q.x + o, q.y - o, q.z, q.w);
}

// The warp moves pieces [from, n) up by d, top down, 32 at a time.
__device__ __forceinline__ void move_pieces(int4* pc, int from, int n, int d, int lane) {
  for (int top = n; top > from; top -= 32) {
    const int p = top - 1 - lane;
    int4 v;
    if (p >= from) v = pc[p];
    __syncwarp();
    if (p >= from) pc[p + d] = v;
    __syncwarp();
  }
}

// Four ints from p[j], j any slot whose four lie in the row: one or two
// aligned 16-byte loads (p 16-byte aligned).
__device__ __forceinline__ int4 load4_at(const int* __restrict__ p, int j) {
  const int4* v = reinterpret_cast<const int4*>(p) + (j >> 2);
  const int4 a = __ldg(v);
  const int s = j & 3;
  if (s == 0) return a;
  const int4 b = __ldg(v + 1);
  return s == 1 ? make_int4(a.y, a.z, a.w, b.x) : s == 2 ? make_int4(a.z, a.w, b.x, b.y)
                                                          : make_int4(a.w, b.x, b.y, b.z);
}

// Four bytes from p[j] as one word (p 4-byte aligned).
__device__ __forceinline__ unsigned load_bytes4_at(const uint8_t* __restrict__ p, int j) {
  const unsigned* v = reinterpret_cast<const unsigned*>(p) + (j >> 2);
  const unsigned a = v[0];
  const int s = j & 3;
  return s == 0 ? a : __funnelshift_r(a, v[1], 8 * s);
}

template <int NT, int MIN_BLOCKS = PIECE_MIN_BLOCKS>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) text_phase_piece_kernel(
    const int* __restrict__ ec_in, const int* __restrict__ ea_in,
    const uint8_t* __restrict__ dl_in, const int* __restrict__ ch_in,
    const int* __restrict__ len_in, const int* __restrict__ ops, int num_ops,
    const int* __restrict__ ranks, int num_ranks,
    const int* __restrict__ char_buf, int buf_len,
    int* __restrict__ ec_out, int* __restrict__ ea_out,
    uint8_t* __restrict__ dl_out, int* __restrict__ ch_out,
    int* __restrict__ oi_out, int* __restrict__ len_out, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = piece_slots(num_ops);
  const int nh = piece_hash_slots(num_ops);
  const int nbits = (cap + 31) / 32 + 1;
  int4* pc = reinterpret_cast<int4*>(smem);                                    // [np]
  int4* rec = pc + np;                                                         // [max(L, 1)]
  auto* hkey = reinterpret_cast<unsigned long long*>(rec + max(num_ops, 1));   // [nh + 1]
  int* hfirst = reinterpret_cast<int*>(hkey + nh + 1);                         // [nh + 1]
  int* hdel = hfirst + nh + 1;                                                 // [nh + 1]
  unsigned* tomb = reinterpret_cast<unsigned*>(hdel + nh + 1);                 // [nbits]
  int* pstart = reinterpret_cast<int*>(tomb + nbits);                          // [np + 1]
  int* scratch = pstart + np + 1;                                              // [PIECE_SCRATCH]
  KeyTable keys{hkey, hfirst, hdel, __ffs(nh) - 1, nh - 1};

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(r) * cap;
  const int* ec_row = ec_in + base;
  const int* ea_row = ea_in + base;
  const int* ch_row = ch_in + base;
  const uint8_t* dl_row = dl_in + base;
  const int* rops = ops + static_cast<size_t>(r) * num_ops * OP_FIELDS;
  const int* rbuf = char_buf + static_cast<size_t>(r) * buf_len;
  const bool vec = cap % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(ec_in) | reinterpret_cast<uintptr_t>(ea_in) |
                    reinterpret_cast<uintptr_t>(ch_in) | reinterpret_cast<uintptr_t>(ec_out) |
                    reinterpret_cast<uintptr_t>(ea_out) | reinterpret_cast<uintptr_t>(ch_out) |
                    reinterpret_cast<uintptr_t>(oi_out)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(dl_in) | reinterpret_cast<uintptr_t>(dl_out)) % 4 == 0;

  for (int i = tid; i <= nh; i += NT) {
    hkey[i] = i < nh ? NO_KEY : 0ull;
    hfirst[i] = INT_MAX;
    hdel[i] = -1;
  }
  for (int i = tid; i < nbits; i += NT) tomb[i] = 0;
  __syncthreads();

  // Step 1: keys, last deletes and the insert records, NT rows at a time.
  int n_ins = 0;
  bool any_key = false, any_del = false;
  for (int row0 = 0; row0 < num_ops; row0 += NT) {
    const int l = row0 + tid;
    int kind = KIND_PAD, ctr = 0, act = 0, rc = 0, ra = 0, run = 1;
    if (l < num_ops) {
      const int* o = rops + static_cast<size_t>(l) * OP_FIELDS;
      kind = __ldg(o + K_KIND);
      ctr = __ldg(o + K_CTR);
      act = __ldg(o + K_ACT);
      rc = __ldg(o + K_REF_CTR);
      ra = __ldg(o + K_REF_ACT);
      if (kind == KIND_INSERT_RUN) run = __ldg(o + K_RUN_LEN);
    }
    const bool is_ins = kind == KIND_INSERT || (kind == KIND_INSERT_RUN && buf_len > 0);
    const bool is_del = kind == KIND_DELETE;
    int slot = -1;
    if (is_del || (is_ins && (rc != 0 || ra != 0))) slot = keys.insert(rc, ra);
    if (is_del) atomicMax(hdel + slot, l);
    const unsigned ins = __ballot_sync(FULL, is_ins);
    if (lane == 0) scratch[warp] = __popc(ins);
    any_key |= __syncthreads_or(slot >= 0) != 0;
    int at = n_ins;
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) at += scratch[w];
      n_ins += scratch[w];
    }
    if (is_ins) rec[at + __popc(ins & ((1u << lane) - 1))] = make_int4(ctr, act, run, l | (slot + 1) << 16);
    any_del |= __syncthreads_or(is_del) != 0;  // and the counts are read
  }

  // The live input slots, when the length is >= 1: first slots and tombstones.
  const int len0 = len_in[r];
  const int live0 = len0 >= 1 ? min(len0, cap) : 0;
  if (any_key) {
    const int groups = vec ? live0 / 4 : 0;
    for (int g = tid; g < groups; g += NT) {
      const int4 c = __ldg(reinterpret_cast<const int4*>(ec_row) + g);
      const int4 a = __ldg(reinterpret_cast<const int4*>(ea_row) + g);
      keys.see_input(4 * g, c.x, a.x, -1, tomb);
      keys.see_input(4 * g + 1, c.y, a.y, -1, tomb);
      keys.see_input(4 * g + 2, c.z, a.z, -1, tomb);
      keys.see_input(4 * g + 3, c.w, a.w, -1, tomb);
    }
    for (int j = 4 * groups + tid; j < live0; j += NT) keys.see_input(j, __ldg(ec_row + j), __ldg(ea_row + j), -1, tomb);
  }
  __syncthreads();

  // Step 2: one warp runs the inserts in row order.
  if (warp == 0) {
    int n = 0;
    if (lane == 0) {
      if (live0 > 0) pc[0] = make_int4(0, live0, 0, 0);
      if (live0 < cap) pc[live0 > 0] = make_int4(live0, (cap - live0) | PIECE_GARBAGE, 0, 0);
    }
    n = (live0 > 0) + (live0 < cap);
    __syncwarp();
    bool pending = len0 < 1;  // no element is live yet
    int live_from = pending ? INT_MAX : -1;  // the row after which the live elements are live
    int length = len0;
    for (int i = 0; i < n_ins; ++i) {
      const int4 rw = rec[i];
      const int ctr = rw.x, act = rw.y, run = rw.z;
      const int l = rw.w & 0xffff;
      const int slot = (rw.w >> 16) - 1;  // -1: the reference is HEAD
      // The insert goes before element o of piece ``at`` (at == n: position C).
      int at = 0, o = 0;
      if (pending) {
        if (slot >= 0) {  // absent, so after element 0
          at = piece_len(pc[0]) > 1 ? 0 : 1;
          o = 1 - at;
        }
      } else {
        if (slot >= 0) {
          // The first live element with the reference id, else element 0.
          const unsigned long long key = slot <= keys.mask ? hkey[slot] : NO_KEY;
          const int rc = static_cast<int>(static_cast<unsigned>(key));
          const int ra = static_cast<int>(static_cast<unsigned>(key >> 32));
          const int first = hfirst[slot];
          int ref = 0;
          for (int p0 = 0; p0 < n; p0 += 32) {
            const int p = p0 + lane;
            bool hit = false;
            int off = 0;
            if (p < n) {
              const int4 q = pc[p];
              if (!(q.y & PIECE_GARBAGE)) {
                off = q.y & PIECE_INSERTED ? static_cast<int>(static_cast<unsigned>(rc) - static_cast<unsigned>(q.z))
                                           : first - q.x;
                hit = static_cast<unsigned>(off) < static_cast<unsigned>(piece_len(q)) &&
                      (!(q.y & PIECE_INSERTED) || q.w == ra);
              }
            }
            const unsigned hits = __ballot_sync(FULL, hit);
            if (hits) {
              const int src = __ffs(hits) - 1;
              at = p0 + src;
              ref = __shfl_sync(FULL, off, src);
              break;
            }
          }
          o = ref + 1;
        }
        // The RGA skip run: past every element that orders after the insert.
        const int op_rank = __ldg(ranks + clampi(act, 0, num_ranks - 1));
        while (at < n) {
          const int4 q = pc[at];
          if (q.y & PIECE_GARBAGE) break;  // the end of the live elements
          const int len = piece_len(q);
          if (o >= len) {
            ++at;
            o = 0;
            continue;
          }
          const int e = o + lane;
          bool stop = false;
          if (e < len) {
            const int2 id = q.y & PIECE_INSERTED
                                ? make_int2(static_cast<int>(static_cast<unsigned>(q.z) + e), q.w)
                                : make_int2(__ldg(ec_row + q.x + e), __ldg(ea_row + q.x + e));
            stop = !greater(id, ctr, op_rank, ranks, num_ranks);
          }
          const unsigned stops = __ballot_sync(FULL, stop);
          if (stops) {
            o += __ffs(stops) - 1;
            break;
          }
          o += 32;
        }
      }
      length = static_cast<int>(static_cast<unsigned>(length) + static_cast<unsigned>(run));
      const int k = min(max(run, 0), cap);
      if (at < n && k > 0) {
        const int4 own = make_int4(l, k | PIECE_INSERTED | (pending ? PIECE_GARBAGE : 0), ctr, act);
        if (o == 0) {
          move_pieces(pc, at, n, 1, lane);
          if (lane == 0) pc[at] = own;
          n += 1;
        } else {
          const int4 q = pc[at];
          move_pieces(pc, at + 1, n, 2, lane);
          if (lane == 0) {
            pc[at] = piece_head(q, o);
            pc[at + 1] = own;
            pc[at + 2] = piece_tail(q, o);
          }
          n += 2;
        }
        __syncwarp();
        // The plane holds C slots: the last k fall off its end.
        for (int drop = k; drop > 0;) {
          const int len = piece_len(pc[n - 1]);
          __syncwarp();
          if (len <= drop) {
            drop -= len;
            --n;
          } else {
            if (lane == 0) pc[n - 1].y -= drop;
            drop = 0;
          }
        }
        __syncwarp();
      }
      if (pending && length >= 1) {
        // Elements first become live: those below the length.
        pending = false;
        live_from = l;
        const int live_end = min(length, cap);
        int acc = 0, live_input = 0;
        for (int p = 0; p < n; ++p) {
          const int4 q = pc[p];
          const int len = piece_len(q);
          __syncwarp();
          if (acc + len <= live_end) {
            if (lane == 0) pc[p].y = q.y & ~PIECE_GARBAGE;
            if (!(q.y & PIECE_INSERTED)) live_input += len;
          } else if (acc < live_end) {
            const int keep = live_end - acc;
            move_pieces(pc, p + 1, n, 1, lane);
            if (lane == 0) {
              pc[p] = piece_head(make_int4(q.x, q.y & ~PIECE_GARBAGE, q.z, q.w), keep);
              const int4 rest = piece_tail(q, keep);
              pc[p + 1] = make_int4(rest.x, rest.y | PIECE_GARBAGE, rest.z, rest.w);
            }
            if (!(q.y & PIECE_INSERTED)) live_input += keep;
            ++n;
            ++p;
          } else if (lane == 0) {
            pc[p].y = q.y | PIECE_GARBAGE;
          }
          __syncwarp();
          acc += len;
        }
        // The live input slots are [0, live_input): as step 1 scans them.
        for (int j = lane; j < live_input; j += 32) {
          keys.see_input(j, __ldg(ec_row + j), __ldg(ea_row + j), live_from, tomb);
        }
        __syncwarp();
      }
    }
    // Each piece's first output slot.
    int acc = 0;
    for (int p0 = 0; p0 < n; p0 += 32) {
      const int p = p0 + lane;
      int v = p < n ? piece_len(pc[p]) : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
      }
      if (p < n) pstart[p + 1] = acc + v;
      acc += __shfl_sync(FULL, v, 31);
    }
    if (lane == 0) {
      pstart[0] = 0;
      scratch[0] = n;
      scratch[1] = live_from;
      scratch[2] = length;
    }
  }
  __syncthreads();

  // Step 3: the planes in one pass over [0, C).
  const int n = scratch[0];
  const int live_from = scratch[1];
  if (tid == 0) len_out[r] = scratch[2];
  // The last piece starting at or before slot s, from ``cur`` on.
  auto piece_of = [&](int cur, int s) {
    int lo = cur, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pstart[mid] <= s) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    return lo;
  };
  // Element o of an inserted piece: id, char, tombstone.
  auto inserted = [&](int4 q, int o, int& c, int& a, int& h, unsigned& dead) {
    const int l = q.x & 0xffff;
    const int off = (q.x >> 16) + o;
    const int* row = rops + static_cast<size_t>(l) * OP_FIELDS;
    const int payload = __ldg(row + K_PAYLOAD);
    c = static_cast<int>(static_cast<unsigned>(q.z) + o);
    a = q.w;
    h = __ldg(row + K_KIND) == KIND_INSERT_RUN
            ? __ldg(rbuf + clampi(payload, 0, buf_len - MAX_RUN_LEN) + min(off, MAX_RUN_LEN - 1))
            : payload;
    dead = 0;
    if (any_del && !(q.y & PIECE_GARBAGE)) {
      const int s = keys.find(c, a);
      dead = s >= 0 && hdel[s] > max(l, live_from);
    }
  };
  // Output slot s, which piece p holds.
  auto element = [&](int p, int s, int& c, int& a, unsigned& d, int& h, int& oi) {
    const int4 q = pc[p];
    const int o = s - pstart[p];
    if (q.y & PIECE_INSERTED) {
      inserted(q, o, c, a, h, d);
      oi = -1;
    } else {
      const int j = q.x + o;
      c = __ldg(ec_row + j);
      a = __ldg(ea_row + j);
      d = dl_row[j] | ((tomb[j >> 5] >> (j & 31)) & 1u);
      h = __ldg(ch_row + j);
      oi = j;
    }
  };
  if (vec) {
    int cur = 0;
    for (int g = tid; g < cap / 4; g += NT) {
      const int s = 4 * g;
      cur = piece_of(cur, s);
      int4 c, a, h, oi;
      unsigned d;
      const int4 q = pc[cur];
      const int o = s - pstart[cur];
      if (s + 4 <= pstart[cur + 1] && !(q.y & PIECE_INSERTED)) {
        // Four input slots in a row.
        const int j = q.x + o;
        c = load4_at(ec_row, j);
        a = load4_at(ea_row, j);
        h = load4_at(ch_row, j);
        const int w = j >> 5, b = j & 31;
        unsigned t = tomb[w] >> b;
        if (b > 28) t |= tomb[w + 1] << (32 - b);
        d = load_bytes4_at(dl_row, j) | (t & 1u) | (t & 2u) << 7 | (t & 4u) << 14 | (t & 8u) << 21;
        oi = make_int4(j, j + 1, j + 2, j + 3);
      } else {
        int cc[4], aa[4], hh[4], ii[4];
        unsigned dd[4];
        if (s + 4 <= pstart[cur + 1]) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            inserted(q, o + u, cc[u], aa[u], hh[u], dd[u]);
            ii[u] = -1;
          }
        } else {
          int p = cur;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            while (pstart[p + 1] <= s + u) ++p;
            element(p, s + u, cc[u], aa[u], dd[u], hh[u], ii[u]);
          }
        }
        c = make_int4(cc[0], cc[1], cc[2], cc[3]);
        a = make_int4(aa[0], aa[1], aa[2], aa[3]);
        h = make_int4(hh[0], hh[1], hh[2], hh[3]);
        oi = make_int4(ii[0], ii[1], ii[2], ii[3]);
        d = dd[0] | dd[1] << 8 | dd[2] << 16 | dd[3] << 24;
      }
      reinterpret_cast<int4*>(ec_out + base)[g] = c;
      reinterpret_cast<int4*>(ea_out + base)[g] = a;
      reinterpret_cast<int4*>(ch_out + base)[g] = h;
      reinterpret_cast<int4*>(oi_out + base)[g] = oi;
      reinterpret_cast<unsigned*>(dl_out + base)[g] = d;
    }
  } else {
    int cur = 0;
    for (int s = tid; s < cap; s += NT) {
      cur = piece_of(cur, s);
      int c, a, h, oi;
      unsigned d;
      element(cur, s, c, a, d, h, oi);
      ec_out[base + s] = c;
      ea_out[base + s] = a;
      dl_out[base + s] = static_cast<uint8_t>(d);
      ch_out[base + s] = h;
      oi_out[base + s] = oi;
    }
  }
}

// Lets the piece form's blocks take ``smem`` bytes each, from a carveout
// that gives shared memory all it can.
cudaError_t set_piece_smem(size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(text_phase_piece_kernel<PIECE_THREADS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(text_phase_piece_kernel<PIECE_THREADS>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch_piece(int replicas, int cap, cudaStream_t stream, const int* ec_in, const int* ea_in,
                         const uint8_t* dl_in, const int* ch_in, const int* len_in, const int* ops,
                         int num_ops, const int* ranks, int num_ranks, const int* char_buf, int buf_len,
                         int* ec_out, int* ea_out, uint8_t* dl_out, int* ch_out, int* oi_out,
                         int* len_out) {
  const size_t smem = piece_smem_bytes(cap, num_ops);
  const cudaError_t err = set_piece_smem(smem);
  if (err != cudaSuccess) return err;
  text_phase_piece_kernel<PIECE_THREADS><<<replicas, PIECE_THREADS, smem, stream>>>(
      ec_in, ea_in, dl_in, ch_in, len_in, ops, num_ops, ranks, num_ranks, char_buf, buf_len,
      ec_out, ea_out, dl_out, ch_out, oi_out, len_out, cap);
  return cudaGetLastError();
}

// The piece form's limits: C <= 16384 (16-bit lengths, 15-bit offsets) and
// row indices below 2^16.
bool piece_shape_ok(int cap, int num_ops) {
  return cap > 0 && cap <= 16384 && num_ops >= 0 && num_ops < (1 << 16) &&
         piece_smem_bytes(cap, num_ops) <= MAX_BLOCK_SMEM;
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

extern "C" size_t pt_text_phase_piece_smem(int cap, int num_ops) { return piece_smem_bytes(cap, num_ops); }

// Blocks of the piece form the card holds on one SM at once at capacity
// ``cap`` and ``num_ops`` op rows into ``blocks``; returns the CUDA error
// code (0 on success).
extern "C" int pt_text_phase_piece_blocks_per_sm(int cap, int num_ops, int* blocks) {
  *blocks = 0;
  if (!piece_shape_ok(cap, num_ops)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = piece_smem_bytes(cap, num_ops);
  const cudaError_t err = set_piece_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, text_phase_piece_kernel<PIECE_THREADS>, PIECE_THREADS, smem));
}

// Launches the text phase's piece form on ``stream``: one block of
// PIECE_THREADS threads per replica, C <= 16384 and fewer than 2^16 op
// rows; the arguments are pt_text_phase's but ``blocks``.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pt_text_phase_piece(
    const void* ec_in, const void* ea_in, const void* dl_in, const void* ch_in,
    const void* len_in, const void* ops, int num_ops, const void* ranks,
    int num_ranks, const void* char_buf, int buf_len, void* ec_out,
    void* ea_out, void* dl_out, void* ch_out, void* oi_out, void* len_out,
    int replicas, int cap, void* stream) {
  if (replicas == 0) return 0;
  if (!piece_shape_ok(cap, num_ops)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_piece(
      replicas, cap, static_cast<cudaStream_t>(stream), static_cast<const int*>(ec_in),
      static_cast<const int*>(ea_in), static_cast<const uint8_t*>(dl_in),
      static_cast<const int*>(ch_in), static_cast<const int*>(len_in),
      static_cast<const int*>(ops), num_ops, static_cast<const int*>(ranks), num_ranks,
      static_cast<const int*>(char_buf), buf_len, static_cast<int*>(ec_out),
      static_cast<int*>(ea_out), static_cast<uint8_t*>(dl_out), static_cast<int*>(ch_out),
      static_cast<int*>(oi_out), static_cast<int*>(len_out)));
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
