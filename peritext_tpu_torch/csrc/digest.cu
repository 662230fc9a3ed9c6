// Convergence digest: an order-sensitive checksum of each replica's visible
// text and resolved marks, one thread block per replica.
//
// Replaces no TPU kernel.  The JAX package computes the digest in XLA
// (peritext_tpu/ops/kernels.py, convergence_digest), and the port's plain
// version is peritext_tpu_torch/ops/kernels.py convergence_digest, which
// this kernel equals byte for byte.  It was added because the plain version
// materialises [rows, C, M'] int64 planes (flatten_sources, expand_mask_bits,
// resolve_winners) and runs a few dozen eager kernels over them: in the
// stream's sweep at C = 16384 that took about 174 ms a cohort of 4,096
// replicas, longer than the cohort's copy and merge together.
//
// The digest, in uint32 arithmetic that wraps (as the plain version's
// int64-and-mask emulation does):
//   live(i)   = i < length and not deleted(i)
//   rank(i)   = the live elements before i
//   char_mix  = sum over live i of chars(i) * 2654435761 + rank(i)
//   V(i)      = sum of the values of the addMark ops that win in element i's
//               effective boundary set
//   mark_mix  = sum over live i of V(i) * (31 * rank(i) + 7)
//   digest    = 2166136261 ^ char_mix ^ (31 * mark_mix)
// Element i's effective set (flatten_sources) is the mask row of the
// nearest source slot at or left of it, where element j < length is a
// source when its "before" slot 2j is defined (then 2j is the slot) or else
// element j - 1's "after" slot 2j - 1 is.  Tombstones count as sources.
// An op m < min(mark_count, M) in the set wins (resolve_winners) when no op
// of its group in the set has a greater key (ctr * (A + 1) + rank of its
// actor, actor and type indices clamped into their tables); the group is the
// type, and for allowMultiple types the type and attribute.
//
// What bounds it on an H100: bytes.  Per replica it needs the chars,
// tombstones and definedness of the elements below length (7 bytes an
// element), the live mark table and one mask row (W words) per source slot:
// about 70 KB a replica for a 10,000-char document at C = 16384 (whose full
// element planes are 114,688 bytes), 0.29 GB a cohort of 4,096, 0.09 ms at
// 3.35 TB/s.  The mask plane ([2C, W] words, 512 KiB a replica at W = 4) is
// read only at source slots.
//
// What the design does about it:
//   - A block walks its replica's elements in tiles of one element a
//     thread, stopping at length, with the next tile's loads issued before
//     the current tile is processed.  Loads are coalesced; no shared memory
//     grows with C, so every capacity takes the same kernel.
//   - Per tile one block scan (warp shuffles, one barrier) gives each
//     element its visible rank (a sum), its source element (a max) and its
//     place among the tile's sources (a sum), each carried across tiles.
//   - The replica's live mark table is staged once in shared memory, sorted
//     by (group, key descending, column): per op its key and value, per
//     sorted position its column and where its group starts.  A source
//     slot's winners are then, per group, the present ops whose key equals
//     that of the group's first present op; a warp resolves a slot 32
//     positions at a time with one ballot and one shuffle, carrying the open
//     group across steps.  O(M) a source slot, O(M^2 / threads) per replica
//     for the sort.
//   - Only source slots are resolved: the tile's sources are compacted and
//     spread over the warps, and V of a source holds for every element up to
//     the next one.  A tile without sources costs one barrier.
// Shared memory is 28 bytes a table column plus 6,656 bytes: 10,240 bytes
// at M = 128, 35,328 at M = 1024.

#include "common.cuh"

namespace {

using namespace pt;

constexpr int DIGEST_THREADS = 512;
constexpr int DIGEST_WARPS = DIGEST_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Planes {
  const int* chars;           // [R, C]
  const uint8_t* deleted;     // [R, C]
  const uint8_t* bnd_def;     // [R, 2C]
  const unsigned* bnd_mask;   // [R, 2C, W]
  const int* length;          // [R]
  const int* mark_count;      // [R]
  const int* ctr;             // [R, M] each of the table columns
  const int* act;
  const int* action;
  const int* type;
  const int* attr;
  const int* ranks;           // [A]
  int n_ranks;
  const uint8_t* multi;       // [T] allowMultiple by type
  int n_multi;
  long long* out;             // [R]
  int cap;
  int words;
  int table_cap;
};

// Shared memory of one block: per table column its key and group key (8 B
// each), value, sorted column and group start (4 B each), plus the tile's
// source lists and the scan and reduction areas; nothing grows with C.
size_t smem_bytes(int table_cap) {
  return static_cast<size_t>(table_cap) * 28 + DIGEST_THREADS * 12 + DIGEST_WARPS * 8 * 4;
}

// One element's loads, issued a tile ahead of their use.
struct Raw {
  int ch;
  int del;
  int before;
  int after;
  int prev_after;  // lane 0 only: the previous element's "after" slot
};

__device__ __forceinline__ Raw load_raw(const Planes& p, size_t row, int len, int i, int lane) {
  Raw e = {0, 1, 0, 0, 0};
  if (i < len) {
    e.ch = p.chars[row + i];
    e.del = p.deleted[row + i];
    e.before = p.bnd_def[2 * (row + i)];
    e.after = p.bnd_def[2 * (row + i) + 1];
    if (lane == 0 && i > 0) e.prev_after = p.bnd_def[2 * (row + i) - 1];
  }
  return e;
}

// The summed value of the addMark ops that win in mask row ``slot``, on
// every lane of the calling warp.  Positions q of the sorted table run 32 a
// step; ``best`` is the key of the first present op of q's group at or
// before q, which is the group's greatest.
__device__ unsigned slot_value(const Planes& p, int r, int slot, int mc, const long long* key,
                               const unsigned* value, const int* perm, const int* gstart, int lane) {
  const unsigned* row = p.bnd_mask + (static_cast<size_t>(r) * 2 * p.cap + slot) * p.words;
  const unsigned upto = lane == 31 ? FULL : (2u << lane) - 1u;
  unsigned acc = 0;
  bool carry_found = false;  // the group open at the step's start has a present op
  long long carry_key = 0;
  for (int base = 0; base < mc; base += 32) {
    const int q = base + lane;
    const bool valid = q < mc;
    const int m = valid ? perm[q] : 0;
    const long long k = valid ? key[m] : 0;
    const int lo = valid ? gstart[q] - base : 0;  // < 0: the group opened in an earlier step
    const bool present = valid && ((__ldg(row + (m >> 5)) >> (m & 31)) & 1u);
    const unsigned bits = __ballot_sync(FULL, present);
    const unsigned cand = bits & upto & (lo <= 0 ? FULL : FULL << lo);
    const long long first = __shfl_sync(FULL, k, cand ? __ffs(cand) - 1 : lane);
    const bool from_carry = lo < 0 && carry_found;
    const bool found = from_carry || cand != 0;
    const long long best = from_carry ? carry_key : first;
    if (present && k == best) acc += value[m];
    carry_found = __shfl_sync(FULL, found, 31);
    carry_key = __shfl_sync(FULL, best, 31);
  }
  return __reduce_add_sync(FULL, acc);
}

__global__ void __launch_bounds__(DIGEST_THREADS) digest_kernel(const Planes p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.table_cap;
  long long* key = reinterpret_cast<long long*>(smem);       // [M] by column
  long long* gkey = key + M;                                 // [M] by column
  unsigned* value = reinterpret_cast<unsigned*>(gkey + M);   // [M] by column, 0 for removeMark
  int* perm = reinterpret_cast<int*>(value + M);             // [M] column at each sorted position
  int* gstart = perm + M;                                    // [M] where each position's group starts
  unsigned* tile_v = reinterpret_cast<unsigned*>(gstart + M);  // [threads] V of the tile's sources
  int* list_pos = reinterpret_cast<int*>(tile_v + DIGEST_THREADS);  // [threads] compacted sources
  int* list_slot = list_pos + DIGEST_THREADS;
  int* scan = list_slot + DIGEST_THREADS;                    // [2][3][warps], by tile parity
  unsigned* red = reinterpret_cast<unsigned*>(scan + 6 * DIGEST_WARPS);  // [2][warps]

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = clampi(p.length[r], 0, p.cap);
  const int mc = clampi(p.mark_count[r], 0, M);
  const size_t row = static_cast<size_t>(r) * p.cap;

  // The live table: each column's group key, resolution key and value.
  const size_t trow = static_cast<size_t>(r) * M;
  for (int m = tid; m < mc; m += DIGEST_THREADS) {
    const int type = p.type[trow + m];
    const int attr = p.attr[trow + m];
    const bool multi = p.multi[clampi(type, 0, p.n_multi - 1)] != 0;
    gkey[m] = static_cast<long long>(type) * 4294967296LL + (multi ? static_cast<long long>(attr) + 1 : 0);
    const int rank = p.ranks[clampi(p.act[trow + m], 0, p.n_ranks - 1)];
    key[m] = static_cast<long long>(p.ctr[trow + m]) * (p.n_ranks + 1) + rank;
    value[m] = p.action[trow + m] == 0
        ? static_cast<unsigned>(type) * 1000003u + (static_cast<unsigned>(attr) + 1u) * 8191u + 17u
        : 0u;
  }
  __syncthreads();
  // Sorted by group key, then key descending, then column.
  for (int m = tid; m < mc; m += DIGEST_THREADS) {
    const long long g = gkey[m];
    const long long k = key[m];
    int pos = 0;
    int start = 0;
    for (int j = 0; j < mc; ++j) {
      const long long gj = gkey[j];
      const long long kj = key[j];
      start += gj < g;
      pos += gj < g || (gj == g && (kj > k || (kj == k && j < m)));
    }
    perm[pos] = m;
    gstart[pos] = start;
  }
  __syncthreads();

  unsigned char_acc = 0;
  unsigned mark_acc = 0;
  int carry_rank = 0;    // live elements before the tile
  int carry_src = -1;    // the last source element before the tile
  unsigned carry_v = 0;  // its V (0 before the first source)
  const int tiles = (len + DIGEST_THREADS - 1) / DIGEST_THREADS;
  Raw next = load_raw(p, row, len, tid, lane);
  for (int t = 0; t < tiles; ++t) {
    const int base = t * DIGEST_THREADS;
    const int i = base + tid;
    const Raw e = next;
    if (t + 1 < tiles) next = load_raw(p, row, len, i + DIGEST_THREADS, lane);

    int prev_after = __shfl_up_sync(FULL, e.after, 1);
    if (lane == 0) prev_after = e.prev_after;
    const bool in = i < len;
    const bool live = in && !e.del;
    const int slot = !in ? -1 : (e.before ? 2 * i : (prev_after ? 2 * i - 1 : -1));
    const bool source = slot >= 0;

    // Block scan: live elements (a sum), the last source (a max), sources (a sum).
    int n_live = live;
    int last_src = source ? i : -1;
    int n_src = source;
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(FULL, n_live, d);
      const int b = __shfl_up_sync(FULL, last_src, d);
      const int c = __shfl_up_sync(FULL, n_src, d);
      if (lane >= d) {
        n_live += a;
        last_src = max(last_src, b);
        n_src += c;
      }
    }
    int* sc = scan + (t & 1) * 3 * DIGEST_WARPS;
    if (lane == 31) {
      sc[warp] = n_live;
      sc[DIGEST_WARPS + warp] = last_src;
      sc[2 * DIGEST_WARPS + warp] = n_src;
    }
    __syncthreads();
    int live_before = carry_rank;
    int src_before = carry_src;
    int src_off = 0;
    int tile_live = 0;
    int tile_src = -1;
    int tile_n_src = 0;
    for (int w = 0; w < DIGEST_WARPS; ++w) {
      const int a = sc[w];
      const int b = sc[DIGEST_WARPS + w];
      const int c = sc[2 * DIGEST_WARPS + w];
      if (w < warp) {
        live_before += a;
        src_before = max(src_before, b);
        src_off += c;
      }
      tile_live += a;
      tile_src = max(tile_src, b);
      tile_n_src += c;
    }
    const unsigned rank = static_cast<unsigned>(live_before + n_live - live);
    const int src = max(src_before, last_src);

    if (mc > 0 && tile_n_src > 0) {
      if (source) {
        list_pos[src_off + n_src - 1] = tid;
        list_slot[src_off + n_src - 1] = slot;
      }
      __syncthreads();
      for (int k = warp; k < tile_n_src; k += DIGEST_WARPS) {
        const unsigned v = slot_value(p, r, list_slot[k], mc, key, value, perm, gstart, lane);
        if (lane == 0) tile_v[list_pos[k]] = v;
      }
      __syncthreads();
    }
    if (live) {
      const unsigned v = mc == 0 ? 0u : (src >= base ? tile_v[src - base] : carry_v);
      char_acc += static_cast<unsigned>(e.ch) * 2654435761u + rank;
      mark_acc += v * (31u * rank + 7u);
    }
    carry_rank += tile_live;
    if (mc > 0 && tile_src >= base) carry_v = tile_v[tile_src - base];
    carry_src = max(carry_src, tile_src);
  }

  char_acc = __reduce_add_sync(FULL, char_acc);
  mark_acc = __reduce_add_sync(FULL, mark_acc);
  if (lane == 0) {
    red[warp] = char_acc;
    red[DIGEST_WARPS + warp] = mark_acc;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned char_mix = 0;
    unsigned mark_mix = 0;
    for (int w = 0; w < DIGEST_WARPS; ++w) {
      char_mix += red[w];
      mark_mix += red[DIGEST_WARPS + w];
    }
    p.out[r] = static_cast<long long>(2166136261u ^ char_mix ^ (31u * mark_mix));
  }
}

}  // namespace

// Each replica's digest into out [R] int64 (a uint32 value), one block a
// replica.  Planes: chars [R, C] int32, deleted [R, C] uint8, bnd_def
// [R, 2C] uint8, bnd_mask [R, 2C, W] int32, length and mark_count [R], the
// table columns ctr, act, action, type, attr [R, M] int32, ranks [A] int32
// (A >= 1), multi [T] uint8 (T >= 1).  Returns the CUDA error code of the
// launch (0 on success); a table whose shared memory (smem_bytes) is past
// one block's is refused before any launch.
extern "C" int pt_digest(const void* chars, const void* deleted, const void* bnd_def,
                         const void* bnd_mask, const void* length, const void* mark_count,
                         const void* ctr, const void* act, const void* action, const void* type,
                         const void* attr, const void* ranks, int n_ranks, const void* multi,
                         int n_multi, void* out, int replicas, int cap, int words, int table_cap,
                         void* stream) {
  if (replicas == 0) return 0;
  if (n_ranks < 1 || n_multi < 1 || table_cap > words * 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(table_cap);
  cudaError_t err = cudaFuncSetAttribute(
      digest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a table past one block's shared memory: leave no error behind
    return static_cast<int>(err);
  }
  const Planes p = {
      static_cast<const int*>(chars), static_cast<const uint8_t*>(deleted),
      static_cast<const uint8_t*>(bnd_def), static_cast<const unsigned*>(bnd_mask),
      static_cast<const int*>(length), static_cast<const int*>(mark_count),
      static_cast<const int*>(ctr), static_cast<const int*>(act), static_cast<const int*>(action),
      static_cast<const int*>(type), static_cast<const int*>(attr),
      static_cast<const int*>(ranks), n_ranks, static_cast<const uint8_t*>(multi), n_multi,
      static_cast<long long*>(out), cap, words, table_cap,
  };
  digest_kernel<<<replicas, DIGEST_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
