// The compact path's ray sort: one sorted round's reorder, and the scatter
// of the results back to launch order.
//
// Replaces no TPU kernel: the JAX package sorts its rounds with XLA
// (jnp.argsort and takes, hmrt_tpu/kernels/compact.py), and the port did the
// same with torch (argsort, one index_select a plane, index_copy_ back),
// about 45 launches a round. kernels/ray_sort.py::ray_sort_reference is that
// chain, the plain version of this file.
//
// What it computes, for P lanes of one march:
//   key   a lane's 32-cell terrain column, coly * m5 + colx
//         (ray_sort.py::column_key), and m5^2, the bucket after every live
//         column, for a dead lane. On a tail round the key is that of the
//         lane forced to level 0 first (ray_sort.py::force_level0), always
//         (tail mode 1) or when the "auto" flag says so (mode 2: more than
//         `thresh` of the live lanes are at level 0, ray_sort.py::
//         l0_tail_flag, written to `flag` for the march kernel to read).
//   perm  the permutation of a stable sort by key: element for element
//         torch.argsort(key, stable=True). K1's per-lane counts keep their
//         lane order by it, and dead lanes go last in lane order.
//   the planes: the state (forced on a tail round), and the planes the
//         caller names (moving ray planes, results), gathered through perm,
//         and the running permutation composed with it.
// `hmrt_ray_unsort` scatters result planes back to launch order.
//
// The key holds m5^2 + 1 values: ceil(log2(m5^2 + 1)) bits, 15 at m = 4096
// (B3), 17 at m = 8192 (B4), fewer on a tiled sub-scene. So the sort is a
// least-significant-digit radix sort over those bits alone, in digits of at
// most DIGIT_MAX bits (two for B3 and B4), each a stable counting sort:
//   1. per-tile histograms of the digit (the key pass makes the first
//      digit's; ray_sort_hist the later ones), stored bucket-major;
//   2. ray_sort_scan: one block a bucket scans its row over the tiles;
//   3. ray_sort_scatter: a tile's elements take their bucket's start (the
//      scan of the bucket totals, made by every block), the counts of the
//      tiles before, the counts of the warps before in the tile and their
//      rank in the warp (match_any ballots), in input order: stable.
// int32 indices throughout. Then one gather launch moves every plane.
//
// What bounds it on the H100: bytes. A reorder cannot avoid reading each
// plane it carries and writing it once, with the running permutation: 13
// planes in and out and perm_in read, 104 B a lane for a B3 primary round,
// 0.064 ms at 3.35 TB/s for 2,073,600 lanes (chip_smoke.py::
// reorder_io_bytes). This design moves more beside that: the key pass
// reads four state planes and writes the key (and on a tail round reads t
// and four ray planes and writes the forced planes, which the gather reads
// back), each radix digit reads and writes key and index, and the gather
// reads the permutation: 56 B a lane more, 100 B on a tail round
// (chip_smoke.py::reorder_sort_bytes). What it does for the rest: one
// launch a stage, no launch for dead lanes' keys or per plane, no int64, no
// memset (each tile writes its whole histogram column), and scratch handed
// in. CUB's radix sort over the same bits, between the same key pass and
// gather (yardsticks/ray_sort_cub.cu), is the yardstick it is timed against.
//
// Nothing here waits on the host, so a round captures into a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;                // threads a block
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                    // elements a thread, per tile
constexpr int TILE = THREADS * ITEMS;       // elements a tile (a block)
constexpr int DIGIT_MAX = 9;                // bits a digit, at most
constexpr int BUCKETS_MAX = 1 << DIGIT_MAX;
constexpr int FLAG_BLOCKS = 256;            // blocks of the "auto" flag's count
constexpr int PLANES_MAX = 12;              // planes a gather carries
constexpr int UNSORT_MAX = 4;               // planes an unsort scatters
constexpr unsigned FULL_WARP = 0xffffffffu;

enum { TAIL_NONE = 0, TAIL_FORCED = 1, TAIL_AUTO = 2 };

// The radix plan of a key of `bits` bits: `digits` digits of `width` bits
// (the last may be narrower).
struct Plan {
  int bits, digits, width;
};

Plan plan_for(int m5) {
  const long long top = (long long)m5 * m5;  // the dead lanes' key, the largest
  int bits = 1;
  while ((top >> bits) != 0) ++bits;
  const int digits = (bits + DIGIT_MAX - 1) / DIGIT_MAX;
  return Plan{bits, digits, (bits + digits - 1) / digits};
}

long long tiles_for(int p) { return ((long long)p + TILE - 1) / TILE; }

// Scratch layout, in int32: key and index twice (ping-pong), the final
// permutation, the forced lvl/icx/icy planes of a tail round, the
// histograms, the bucket totals, the flag's partial counts.
struct Scratch {
  int *key_a, *key_b, *idx_a, *idx_b, *perm, *lvl, *icx, *icy, *hist, *totals, *partials;
};

long long scratch_ints(int p, int tail_mode) {
  return (long long)p * (5 + (tail_mode != TAIL_NONE ? 3 : 0)) +
         (long long)BUCKETS_MAX * tiles_for(p) + BUCKETS_MAX + 2 * FLAG_BLOCKS;
}

Scratch carve(int* s, int p, int tail_mode) {
  Scratch c{};
  int** planes[] = {&c.key_a, &c.key_b, &c.idx_a, &c.idx_b, &c.perm};
  for (int** x : planes) {
    *x = s;
    s += p;
  }
  if (tail_mode != TAIL_NONE) {
    c.lvl = s;
    c.icx = s + p;
    c.icy = s + 2 * (long long)p;
    s += 3 * (long long)p;
  }
  c.hist = s;
  s += (long long)BUCKETS_MAX * tiles_for(p);
  c.totals = s;
  c.partials = s + BUCKETS_MAX;
  return c;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Exclusive scan of one int a thread over the block; `total` takes the sum.
// `warp_sums` is WARPS ints of shared memory.
__device__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_WARP, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int y = __shfl_up_sync(FULL_WARP, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = w > 0 ? warp_sums[w - 1] : 0;
  total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums may be used again
  return before + x - v;
}

// Sum of one int a thread over the block (valid in every thread).
__device__ int block_sum(int v, int* warp_sums) {
  int total;
  block_exclusive_scan(v, warp_sums, total);
  return total;
}

// Add each element's digit to the tile's shared histogram: one shared
// atomic per group of equal digits in the warp. `d` is the digit, or
// `buckets` for an element past the end.
__device__ __forceinline__ void count_digit(int* hist, int d, int buckets) {
  const unsigned peers = __match_any_sync(FULL_WARP, d);
  if (d < buckets && (peers & lanemask_lt()) == 0) atomicAdd(hist + d, __popc(peers));
}

// Write the tile's histogram into its column of the bucket-major table.
__device__ void store_column(const int* hist, int* table, int buckets, long long tiles) {
  for (int b = threadIdx.x; b < buckets; b += THREADS)
    table[(long long)b * tiles + blockIdx.x] = hist[b];
}

// ray_sort.py::force_level0 for one coordinate: the level-0 cell of the
// position o + t d clamped under the level-lvl cell c (f32 multiply then
// add, as torch rounds them; the build has no FMA contraction).
__device__ __forceinline__ int descend(float o, float d, float t, int c, int lvl) {
  const int lo = (int)((unsigned)c << lvl);
  const int hi = lo + (1 << lvl) - 1;
  const float f = floorf(o + t * d);
  return (int)fminf(fmaxf(f, (float)lo), (float)hi);
}

// The "auto" tail's count: lanes alive and lanes alive at level 0, one
// pair of partial sums a block.
__global__ void __launch_bounds__(THREADS)
    ray_sort_flag_count(const int* __restrict__ alive, const int* __restrict__ lvl, int p,
                        int* __restrict__ partials) {
  __shared__ int warp_sums[WARPS];
  int n_alive = 0, n_l0 = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < p;
       i += (long long)gridDim.x * THREADS) {
    const bool a = __ldg(alive + i) != 0;
    n_alive += a;
    n_l0 += a && __ldg(lvl + i) == 0;
  }
  n_alive = block_sum(n_alive, warp_sums);
  n_l0 = block_sum(n_l0, warp_sums);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = n_alive;
    partials[2 * blockIdx.x + 1] = n_l0;
  }
}

struct KeyIn {
  const int *alive, *lvl, *icx, *icy;
  const float *t, *ox, *oy, *dx, *dy;
};

// The key pass: each lane's key (forced to level 0 on a tail round, whose
// state planes it writes to the scratch), and the first digit's histogram
// of each tile.
__global__ void __launch_bounds__(THREADS)
    ray_sort_key(const KeyIn in, int p, int m5, int tail_mode, float thresh,
                 const int* __restrict__ partials, int* __restrict__ flag, Scratch s,
                 int digit_bits, long long tiles) {
  __shared__ int hist[BUCKETS_MAX];
  __shared__ int warp_sums[WARPS];
  const int buckets = 1 << digit_bits;
  for (int b = threadIdx.x; b < buckets; b += THREADS) hist[b] = 0;
  bool tail = tail_mode == TAIL_FORCED;
  if (tail_mode == TAIL_AUTO) {  // every block sums the partial counts itself
    const int n_alive = block_sum(threadIdx.x < FLAG_BLOCKS ? partials[2 * threadIdx.x] : 0,
                                  warp_sums);
    const int n_l0 = block_sum(threadIdx.x < FLAG_BLOCKS ? partials[2 * threadIdx.x + 1] : 0,
                               warp_sums);
    // ray_sort.py::l0_tail_flag: n_l0 > int(thresh * float(n_alive)) in f32
    tail = n_l0 > (int)__fmul_rn(thresh, (float)n_alive);
    if (blockIdx.x == 0 && threadIdx.x == 0) *flag = tail;
  }
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
  const int dead = m5 * m5;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    int d = buckets;
    if (i < p) {
      int lvl = __ldg(in.lvl + i), icx = __ldg(in.icx + i), icy = __ldg(in.icy + i);
      if (tail_mode != TAIL_NONE) {
        if (tail) {
          const float t = __ldg(in.t + i);
          icx = descend(__ldg(in.ox + i), __ldg(in.dx + i), t, icx, lvl);
          icy = descend(__ldg(in.oy + i), __ldg(in.dy + i), t, icy, lvl);
          lvl = 0;
        }
        s.lvl[i] = lvl;
        s.icx[i] = icx;
        s.icy[i] = icy;
      }
      int key = dead;
      if (__ldg(in.alive + i) != 0) {
        const int colx = min(max((int)((unsigned)icx << lvl) >> 5, 0), m5 - 1);
        const int coly = min(max((int)((unsigned)icy << lvl) >> 5, 0), m5 - 1);
        key = coly * m5 + colx;
      }
      s.key_a[i] = key;
      d = key & (buckets - 1);
    }
    count_digit(hist, d, buckets);
  }
  __syncthreads();
  store_column(hist, s.hist, buckets, tiles);
}

// The histogram of digit (key >> shift) & (buckets - 1) of each tile.
__global__ void __launch_bounds__(THREADS)
    ray_sort_hist(const int* __restrict__ keys, int p, int shift, int digit_bits,
                  int* __restrict__ table, long long tiles) {
  __shared__ int hist[BUCKETS_MAX];
  const int buckets = 1 << digit_bits;
  for (int b = threadIdx.x; b < buckets; b += THREADS) hist[b] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    count_digit(hist, i < p ? (__ldg(keys + i) >> shift) & (buckets - 1) : buckets, buckets);
  }
  __syncthreads();
  store_column(hist, table, buckets, tiles);
}

// One block a bucket: the exclusive scan of its row of tile counts, in
// place, and the row's total.
__global__ void __launch_bounds__(THREADS)
    ray_sort_scan(int* __restrict__ table, long long tiles, int* __restrict__ totals) {
  __shared__ int warp_sums[WARPS];
  int* row = table + (long long)blockIdx.x * tiles;
  constexpr int PER = 4;
  int carry = 0;
  for (long long at = 0; at < tiles; at += THREADS * PER) {
    int v[PER], sum = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const long long j = at + (long long)threadIdx.x * PER + k;
      v[k] = j < tiles ? row[j] : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, warp_sums, total);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const long long j = at + (long long)threadIdx.x * PER + k;
      if (j < tiles) row[j] = run;
      run += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One digit's stable scatter. Warp w of a tile holds its elements
// [w * 32 * ITEMS, (w + 1) * 32 * ITEMS), 32 consecutive ones an item, so
// an element's place among its digit's elements of the tile is the count
// of the warps before, that of its warp's earlier items, and its lanes
// before it with the same digit. `idx_in` null: the identity (the first
// digit). The last digit writes the permutation alone.
template <bool kLast>
__global__ void __launch_bounds__(THREADS)
    ray_sort_scatter(const int* __restrict__ keys, const int* __restrict__ idx_in, int p,
                     int shift, int digit_bits, const int* __restrict__ table,
                     const int* __restrict__ totals, long long tiles,
                     int* __restrict__ keys_out, int* __restrict__ idx_out) {
  __shared__ int warp_hist[WARPS * BUCKETS_MAX];  // warp w's counts at [w * buckets + d]
  __shared__ int start[BUCKETS_MAX];              // the tile's first place in each bucket
  __shared__ int warp_sums[WARPS];
  const int buckets = 1 << digit_bits;
  for (int b = threadIdx.x; b < WARPS * buckets; b += THREADS) warp_hist[b] = 0;
  {  // each bucket's start: the scan of the totals, plus the tiles before
    static_assert(BUCKETS_MAX <= 2 * THREADS, "two buckets a thread");
    const int b = 2 * threadIdx.x;
    const int v0 = b < buckets ? totals[b] : 0, v1 = b + 1 < buckets ? totals[b + 1] : 0;
    int total;
    const int before = block_exclusive_scan(v0 + v1, warp_sums, total);
    if (b < buckets) start[b] = before + table[(long long)b * tiles + blockIdx.x];
    if (b + 1 < buckets)
      start[b + 1] = before + v0 + table[(long long)(b + 1) * tiles + blockIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * TILE + (long long)w * 32 * ITEMS + lane;
  int key[ITEMS], src[ITEMS], dig[ITEMS], rank[ITEMS];
  int* mine = warp_hist + w * buckets;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * 32;
    const bool in = i < p;
    key[k] = in ? __ldg(keys + i) : 0;
    src[k] = !in ? 0 : idx_in != nullptr ? __ldg(idx_in + i) : (int)i;
    dig[k] = in ? (key[k] >> shift) & (buckets - 1) : buckets;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const unsigned peers = __match_any_sync(FULL_WARP, dig[k]);
    const int ahead = __popc(peers & lanemask_lt());
    const int seen = dig[k] < buckets ? mine[dig[k]] : 0;
    rank[k] = seen + ahead;
    __syncwarp();
    if (dig[k] < buckets && ahead == 0) mine[dig[k]] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first place in each bucket
  for (int b = threadIdx.x; b < buckets; b += THREADS) {
    int run = start[b];
#pragma unroll
    for (int v = 0; v < WARPS; ++v) {
      const int c = warp_hist[v * buckets + b];
      warp_hist[v * buckets + b] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (dig[k] == buckets) continue;
    const int at = mine[dig[k]] + rank[k];
    if (!kLast) keys_out[at] = key[k];
    idx_out[at] = src[k];
  }
}

struct Gather {
  const int* src[PLANES_MAX];
  int* dst[PLANES_MAX];
  int n;
};

// Every plane through the permutation, and the running permutation
// composed with it (`perm_in` null: the first round, whose running
// permutation is this one).
__global__ void __launch_bounds__(THREADS)
    ray_sort_gather(const int* __restrict__ perm, int p, const Gather g,
                    const int* __restrict__ perm_in, int* __restrict__ perm_out) {
  const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (k >= p) return;
  const int s = __ldg(perm + k);
  int v[PLANES_MAX];
#pragma unroll
  for (int j = 0; j < PLANES_MAX; ++j)
    if (j < g.n) v[j] = __ldg(g.src[j] + s);
  const int tot = perm_in != nullptr ? __ldg(perm_in + s) : s;
#pragma unroll
  for (int j = 0; j < PLANES_MAX; ++j)
    if (j < g.n) g.dst[j][k] = v[j];
  perm_out[k] = tot;
}

struct Unsort {
  const int* src[UNSORT_MAX];
  int* dst[UNSORT_MAX];
  int n;
};

// Lane k of the sorted planes back to launch lane perm[k].
__global__ void __launch_bounds__(THREADS)
    ray_unsort_scatter(const int* __restrict__ perm, int p, const Unsort u) {
  const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (k >= p) return;
  const int d = __ldg(perm + k);
  int v[UNSORT_MAX];
#pragma unroll
  for (int j = 0; j < UNSORT_MAX; ++j)
    if (j < u.n) v[j] = __ldg(u.src[j] + k);
#pragma unroll
  for (int j = 0; j < UNSORT_MAX; ++j)
    if (j < u.n) u.dst[j][d] = v[j];
}

int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

// One round's arguments (hmrt_ray_sort's, below) and what they give.
struct Round {
  KeyIn in;
  const void* const* src;
  void* const* dst;
  int n_extra;
  void* const* state_o;
  const int* perm_in;
  int* perm_out;
  int* flag;
  int p, m5, tail_mode;
  float thresh;
  cudaStream_t st;
  Plan plan;
  long long tiles;
  Scratch s;
};

bool round_ok(const Round& r, int scratch_n) {
  return r.p >= 0 && r.m5 >= 1 && r.m5 <= 46340 && r.tail_mode >= TAIL_NONE &&
         r.tail_mode <= TAIL_AUTO && r.n_extra >= 0 && r.n_extra + 5 <= PLANES_MAX &&
         (r.tail_mode != TAIL_AUTO || r.flag != nullptr) &&
         (r.tail_mode == TAIL_NONE || (r.in.ox != nullptr && r.in.oy != nullptr &&
                                       r.in.dx != nullptr && r.in.dy != nullptr)) &&
         scratch_n >= scratch_ints(r.p, r.tail_mode);
}

// The key pass, after the "auto" flag's count: keys in s.key_a, the first
// digit's histograms, a tail round's forced planes.
void launch_key(const Round& r) {
  if (r.tail_mode == TAIL_AUTO)
    ray_sort_flag_count<<<FLAG_BLOCKS, THREADS, 0, r.st>>>(r.in.alive, r.in.lvl, r.p,
                                                           r.s.partials);
  ray_sort_key<<<(int)r.tiles, THREADS, 0, r.st>>>(r.in, r.p, r.m5, r.tail_mode, r.thresh,
                                                   r.s.partials, r.flag, r.s, r.plan.width,
                                                   r.tiles);
}

// The radix digits over s.key_a: the permutation in s.perm.
void launch_radix(const Round& r) {
  const Scratch& s = r.s;
  const int* keys = s.key_a;
  const int* idx = nullptr;
  for (int d = 0; d < r.plan.digits; ++d) {
    const int shift = d * r.plan.width;
    const int bits = r.plan.bits - shift < r.plan.width ? r.plan.bits - shift : r.plan.width;
    if (d > 0)
      ray_sort_hist<<<(int)r.tiles, THREADS, 0, r.st>>>(keys, r.p, shift, bits, s.hist, r.tiles);
    ray_sort_scan<<<1 << bits, THREADS, 0, r.st>>>(s.hist, r.tiles, s.totals);
    if (d == r.plan.digits - 1) {
      ray_sort_scatter<true><<<(int)r.tiles, THREADS, 0, r.st>>>(
          keys, idx, r.p, shift, bits, s.hist, s.totals, r.tiles, nullptr, s.perm);
    } else {
      int* k_out = d % 2 == 0 ? s.key_b : s.key_a;
      int* i_out = d % 2 == 0 ? s.idx_a : s.idx_b;
      ray_sort_scatter<false><<<(int)r.tiles, THREADS, 0, r.st>>>(
          keys, idx, r.p, shift, bits, s.hist, s.totals, r.tiles, k_out, i_out);
      keys = k_out;
      idx = i_out;
    }
  }
}

// Every plane through s.perm, and the running permutation composed.
void launch_gather(const Round& r) {
  const bool forced = r.tail_mode != TAIL_NONE;
  Gather g{};
  const int* state_in[5] = {r.in.alive, reinterpret_cast<const int*>(r.in.t),
                            forced ? r.s.lvl : r.in.lvl, forced ? r.s.icx : r.in.icx,
                            forced ? r.s.icy : r.in.icy};
  for (int j = 0; j < 5; ++j) {
    g.src[j] = state_in[j];
    g.dst[j] = static_cast<int*>(r.state_o[j]);
  }
  for (int j = 0; j < r.n_extra; ++j) {
    g.src[5 + j] = static_cast<const int*>(r.src[j]);
    g.dst[5 + j] = static_cast<int*>(r.dst[j]);
  }
  g.n = 5 + r.n_extra;
  ray_sort_gather<<<blocks_for(r.p), THREADS, 0, r.st>>>(r.s.perm, r.p, g, r.perm_in,
                                                         r.perm_out);
}

Round make_round(const int* alive, const float* t, const int* lvl, const int* icx,
                 const int* icy, const float* ox, const float* oy, const float* dx,
                 const float* dy, const void* const* src, void* const* dst, int n_extra,
                 void* const* state_o, const int* perm_in, int* perm_out, int* flag,
                 int* scratch, int p, int m5, int tail_mode, float thresh, void* stream) {
  Round r{};
  r.in = KeyIn{alive, lvl, icx, icy, t, ox, oy, dx, dy};
  r.src = src;
  r.dst = dst;
  r.n_extra = n_extra;
  r.state_o = state_o;
  r.perm_in = perm_in;
  r.perm_out = perm_out;
  r.flag = flag;
  r.p = p;
  r.m5 = m5;
  r.tail_mode = tail_mode;
  r.thresh = thresh;
  r.st = (cudaStream_t)stream;
  if (m5 >= 1 && m5 <= 46340) r.plan = plan_for(m5);
  if (p >= 0 && tail_mode >= TAIL_NONE && tail_mode <= TAIL_AUTO) {
    r.tiles = tiles_for(p);
    r.s = carve(scratch, p, tail_mode);
  }
  return r;
}

}  // namespace

// The int32 scratch a round of p lanes needs (tail_mode 0: no tail, 1:
// forced, 2: "auto"), or -1 past int range.
extern "C" int hmrt_ray_sort_scratch(int p, int tail_mode) {
  const long long n = scratch_ints(p, tail_mode);
  return n > 0x7fffffffll ? -1 : (int)n;
}

// One sorted round. State planes in (alive, t, lvl, icx, icy) and out
// (state_o, 5 planes); ox oy dx dy are read on a tail round only (null
// otherwise); `src`/`dst`: n_extra more 4-byte planes to gather (moving ray
// planes, results); perm_in: the running permutation or null; perm_out
// takes it composed; flag: one int32, written on an "auto" round (may be
// null otherwise); scratch: `scratch_n` int32 (hmrt_ray_sort_scratch).
// Returns cudaErrorInvalidValue, launching nothing, on a bad argument.
extern "C" int hmrt_ray_sort(const int* alive, const float* t, const int* lvl, const int* icx,
                             const int* icy, const float* ox, const float* oy,
                             const float* dx, const float* dy, const void* const* src,
                             void* const* dst, int n_extra, void* const* state_o,
                             const int* perm_in, int* perm_out, int* flag, int* scratch,
                             int scratch_n, int p, int m5, int tail_mode, float thresh,
                             void* stream) {
  const Round r = make_round(alive, t, lvl, icx, icy, ox, oy, dx, dy, src, dst, n_extra,
                             state_o, perm_in, perm_out, flag, scratch, p, m5, tail_mode,
                             thresh, stream);
  if (!round_ok(r, scratch_n)) return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  launch_key(r);
  launch_radix(r);
  launch_gather(r);
  return (int)cudaGetLastError();
}

// Result planes back to launch order: dst[j][perm[k]] = src[j][k] for
// n planes of 4 bytes (at most UNSORT_MAX).
extern "C" int hmrt_ray_unsort(const int* perm, const void* const* src, void* const* dst, int n,
                               int p, void* stream) {
  if (p < 0 || n < 1 || n > UNSORT_MAX) return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  Unsort u{};
  for (int j = 0; j < n; ++j) {
    u.src[j] = static_cast<const int*>(src[j]);
    u.dst[j] = static_cast<int*>(dst[j]);
  }
  u.n = n;
  ray_unsort_scatter<<<blocks_for(p), THREADS, 0, (cudaStream_t)stream>>>(perm, p, u);
  return (int)cudaGetLastError();
}
