// One budgeted max-mip march pass over flat ray-state planes.
//
// Replaces the TPU kernel hmrt_tpu/kernels/compact.py::_march_pass_kernel
// (launched by compact.py::march_pass). It computes what that kernel
// computes: every ray that is alive takes up to `budget` steps of the
// max-mip march (the body of hmrt_tpu/traversal/march.py::march_maxmip,
// without the cone branch) and its state and hit results are written back,
// so the caller can re-sort the survivors between passes. The Mosaic
// schedule of the TPU kernel (column records, the demand loop, DMA
// semaphores, banks, subserve, unroll, lane-shuffle gathers) existed only
// because the TPU has no texture unit and no dynamic vector gather; here
// the pyramid and the level-0 corner records are read with plain loads.
//
// What bounds the max-mip march on the H100: the steps themselves, most of
// them level-0 cell tests with two IEEE divisions each, at a few times
// their operations bound; the sorted rays keep 98% of a warp's lanes busy
// even without refill (PERF.md, chip_smoke.py phase 10). Of what was
// measured, more warps per SM (fewer registers) helped; deeper prefetch
// and fewer instructions per step did not. What this design does:
//   - one 16-byte corner record per level-0 step, prefetched RING cells
//     ahead along the ray (march_common.cuh);
//   - persistent warps: one resident wave walks all p rays. A warp's idle
//     lanes claim the next ray indices from a device counter, every lane
//     marches CHUNK steps, and a lane whose ray died or used its budget
//     writes it back and goes idle (the "while-while" loop with dynamic ray
//     fetch of Aila and Laine, HPG 2009). Claiming in index order keeps a
//     warp's rays in nearby terrain: the caller's sorted rounds order them
//     by column.
// The budget is per ray and march_steps composes over budgets, so any
// chunking and any order of claiming gives the same planes.
//
// The constants below were measured on the B3 frame (kernel_times.py,
// PERF.md). A warp refills only once all its lanes are idle: refilling at
// 8, 16, 24 or 28 idle lanes was slower, because a fresh ray starts with
// steps at the upper levels while its warp-mates are deep in level-0 runs,
// and the step's branches then diverge; the tail that refill removes is 2%
// of the lanes. Blocks of 64 threads let the SM take warps in finer steps
// of registers.
//
// The step itself is `march_steps` of march_common.cuh, shared with the
// fused tile kernel; its float expressions are those of the torch and JAX
// march, in the same order.
//
// The tail modes of the TPU kernel (its `l0_only` and `relax` arguments) are
// template instances beside COUNT, so that the max-mip instance the passes
// before the tail run keeps its registers: MODE_L0 marches the level-0 tail
// with the exact test (l0_min_steps), MODE_RELAX the relaxed stride tail
// (relaxed_steps, which passes under the terrain by the same blocks and ends
// under the same floor as l0_min_steps).
// With a tail flag (the compact path's "auto" tail, decided on the device)
// a tail instance reads it once and, when it is 0, runs the max-mip march
// instead: a uniform branch, no host wait.
//
// What the level-0 tail is on the card: rays that entered the map's wall
// below the surface and march beneath it without a hit (B3: 513,374 of
// them, 2,034,433,443 cells a frame, every one an exact test). Earlier
// designs made each test cheaper or hid its load; what removed the time is
// not testing the cells such a ray cannot reach. One lane marches one ray
// (l0_min_steps, with the ring of march_steps while at level 0), on the
// persistent warps of the max-mip march, passes under whole blocks of the
// min pyramid and ends a descending ray under the map's lowest height
// (march_common.cuh): B3's tail takes 3,442,487 steps and 2,076 cell tests,
// and its launch 0.236 ms instead of 14.4 (kernel_times.py, PERF.md). The
// launch records which march it ran in a tally on the card (march_pass.py
// `mode_launches`).
// Measured and dropped before the min skip: a triangle test that skipped
// the division where the window already settled it (B3's tail 25%
// slower), refilling a warp of the one-lane march at 8 idle lanes (3%
// slower), groups of 4 (never the faster one). Measured and dropped after
// it: groups of 32 lanes a ray, each testing 32 consecutive cells of the
// ray a window (B4's tail launch 0.185 ms against 0.082 for one lane a
// ray, B3's 8,192 tail rays 0.288 against 0.069; PERF.md).

#include <cuda_runtime.h>

#include "march_common.cuh"

namespace {

constexpr int THREADS = 64;
// steps a lane marches between two looks at the queue (each look drops the
// prefetch ring)
constexpr int CHUNK = 256;
// idle lanes of a warp that make it claim new rays (the level-0 tail's
// march of one lane a ray as well: 8 was 3% slower there, PERF.md)
constexpr int REFILL_MIN = 32;
// blocks an SM must hold at once: caps the registers a thread may use
// (1: no cap; a cap that buys more warps made ptxas spill). Uncapped, the
// timed instances take 76 to 78 registers without a spill, 24 warps an SM
// (PERF.md).
constexpr int MIN_BLOCKS = 1;
// what a pass marches (march_pass.py MODE_*)
constexpr int MODE_MAXMIP = 0, MODE_L0 = 1, MODE_RELAX = 2;
// what a launch ran, the slots of its tally (march_pass.py TALLY_KEYS)
constexpr int RAN_MAXMIP = 0, RAN_L0 = 1, RAN_RELAX = 2;

struct Planes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int* alive;
  const float* t;
  const int *lvl, *icx, *icy, *hit;
  const float* t_hit;
  const int *hx, *hy;
  int* alive_o;
  float* t_o;
  int *lvl_o, *icx_o, *icy_o, *hit_o;
  float* t_hit_o;
  int *hx_o, *hy_o;
  int* counts;  // (2, p) steps and cell tests per ray, COUNT instances only
};

// Ray i's state and results as it leaves the pass: `s` and the hit `h` of
// its last steps (a ray that hit in this pass ends there; any other keeps
// the results it came with), and its counts.
template <bool COUNT>
static __device__ __forceinline__ void write_ray(const Planes& a, long long i, int p,
                                                 const MarchState& s, const MarchHit& h,
                                                 const Work& w) {
  a.alive_o[i] = s.alive;
  a.t_o[i] = s.t;
  a.lvl_o[i] = s.lvl;
  a.icx_o[i] = s.icx;
  a.icy_o[i] = s.icy;
  a.hit_o[i] = h.hit ? 1 : a.hit[i];
  a.t_hit_o[i] = h.hit ? h.t_hit : a.t_hit[i];
  a.hx_o[i] = h.hit ? h.hx : a.hx[i];
  a.hy_o[i] = h.hit ? h.hy : a.hy[i];
  if (COUNT) {
    a.counts[i] = w.steps;
    a.counts[(long long)p + i] = w.tests;
  }
}

// Ray i as march_pass.py reads it: the direction's inverses and the exit
// t1 of the box (ray_inverses / ray_box_range).
static __device__ __forceinline__ MarchRay load_ray(const Planes& a, long long i, float box_lo,
                                                   float box_hi) {
  MarchRay r;
  r.ox = a.ox[i], r.oy = a.oy[i], r.oz = a.oz[i];
  r.dx = a.dx[i], r.dy = a.dy[i], r.dz = a.dz[i];
  r.inv_x = 1.0f / safe(r.dx);
  r.inv_y = 1.0f / safe(r.dy);
  float t0;
  ray_box(r.ox, r.oy, r.inv_x, r.inv_y, box_lo, box_hi, t0, r.t1);
  return r;
}

template <bool COUNT, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    march_pass_kernel(const Planes a, const Terrain g, const float* __restrict__ pyr_min, int p,
                      int budget, int stride, float box_lo, float box_hi, const int* tail_flag,
                      int* tally, int* next) {
  const float gmax = __ldg(g.pyr + pyramid_top(g.m));
  // the tail instances run their tail unless the flag says otherwise
  const bool tail = MODE != MODE_MAXMIP && (tail_flag == nullptr || __ldg(tail_flag) != 0);
  // the map's lowest height, the min pyramid's top (its one entry when m = 1)
  const long long min_top = max(pyramid_top(g.m) - (long long)g.m * g.m, 0ll);
  const float gmin = MODE != MODE_MAXMIP && tail ? __ldg(pyr_min + min_top) : 0.0f;
  if (tally != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(tally + (!tail ? RAN_MAXMIP : MODE == MODE_RELAX ? RAN_RELAX : RAN_L0), 1);
  int i = -1;        // the ray this lane holds; -1: idle
  int used = 0;      // steps the held ray has taken in this pass
  bool more = true;  // the counter still hands out rays (warp-uniform)
  MarchRay r{};
  MarchState s{};
  Work w{0, 0};
  for (;;) {
    const int k = claim_item(next, p, i < 0, REFILL_MIN, more);
    if (k >= 0) {
      i = k;
      used = 0;
      w = Work{0, 0};
      s = MarchState{a.alive[i], a.t[i], a.lvl[i], a.icx[i], a.icy[i]};
      if (MODE == MODE_RELAX) {  // relaxed_planes: sampling from here
        s.rmode = 0;
        s.tprev = s.t;
        s.wend = BIG_T;
      }
      if (s.alive) r = load_ray(a, i, box_lo, box_hi);
    }
    if (!__any_sync(FULL_WARP, i >= 0)) break;  // a warp with no ray has claimed past p

    if (i >= 0) {
      MarchHit h{0, BIG_T, 0, 0};
      const int steps = min(CHUNK, budget - used);
      if (MODE == MODE_RELAX && tail)
        used += relaxed_steps<COUNT>(r, s, h, steps, g, pyr_min, gmin, gmax, stride, w);
      else if (MODE == MODE_L0 && tail)
        used += l0_min_steps<COUNT>(r, s, h, steps, g, pyr_min, gmin, gmax, w);
      else
        used += march_steps<COUNT>(r, s, h, steps, g, gmax, w);
      if (!s.alive || used >= budget) {  // a hit ends the ray in its last chunk
        write_ray<COUNT>(a, i, p, s, h, w);
        i = -1;
      }
    }
  }
}

// The launch's arguments after the planes and the terrain.
struct Pass {
  const float* pyr_min;
  int p, budget, stride;
  float box_lo, box_hi;
  const int* tail_flag;
  int* tally;
  int* next;
};

template <bool COUNT, int MODE>
int launch(const Planes& a, const Terrain& g, const Pass& q, cudaStream_t stream) {
  const int blocks = persistent_blocks(march_pass_kernel<COUNT, MODE>, THREADS, q.p);
  march_pass_kernel<COUNT, MODE><<<blocks, THREADS, 0, stream>>>(
      a, g, q.pyr_min, q.p, q.budget, q.stride, q.box_lo, q.box_hi, q.tail_flag, q.tally,
      q.next);
  return (int)cudaGetLastError();
}

template <bool COUNT>
int launch_mode(int mode, const Planes& a, const Terrain& g, const Pass& q,
                cudaStream_t stream) {
  if (mode == MODE_L0) return launch<COUNT, MODE_L0>(a, g, q, stream);
  if (mode == MODE_RELAX) return launch<COUNT, MODE_RELAX>(a, g, q, stream);
  return launch<COUNT, MODE_MAXMIP>(a, g, q, stream);
}

}  // namespace

// `mode` is MODE_MAXMIP, MODE_L0 or MODE_RELAX (then `stride` > 0 cells and
// an unbudgeted pass); a tail mode reads `pyr_min`, the flat min pyramid of
// levels >= 1, which is not null. `tail_flag` is null (a tail mode always
// runs its tail) or one int32 on the device. `tally` is null or three int32
// on the device, one of which each launch adds 1 to (RAN_*). `next` is a
// zeroed int32 on the device (the ray counter); `counts` is null or an
// int32 (2, p) plane that takes each ray's steps and cell tests. An unknown
// mode, a tail mode without `pyr_min`, or a relaxed pass with a budget or
// no stride, returns cudaErrorInvalidValue and launches nothing.
extern "C" int hmrt_march_pass(const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const int* alive, const float* t, const int* lvl,
                               const int* icx, const int* icy, const int* hit,
                               const float* t_hit, const int* hx, const int* hy,
                               int* alive_o, float* t_o, int* lvl_o, int* icx_o,
                               int* icy_o, int* hit_o, float* t_hit_o, int* hx_o,
                               int* hy_o, const float* pyr_flat, const float* corners,
                               const float* pyr_min, int p, int m, int levels, int budget,
                               int intersector, int mode,
                               int stride, float box_lo, float box_hi, const int* tail_flag,
                               int* tally, int* next, int* counts, void* stream) {
  if (mode < MODE_MAXMIP || mode > MODE_RELAX ||
      (mode == MODE_RELAX && (stride <= 0 || budget != UNBUDGETED)) ||
      (mode != MODE_MAXMIP && pyr_min == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p <= 0) return (int)cudaSuccess;
  Planes a{ox,    oy,    oz,    dx,   dy,   dz,   alive,   t,     lvl,  icx,
           icy,   hit,   t_hit, hx,   hy,   alive_o, t_o,  lvl_o, icx_o, icy_o,
           hit_o, t_hit_o, hx_o, hy_o, counts};
  Terrain g{pyr_flat, reinterpret_cast<const float4*>(corners), m, levels, intersector};
  const Pass q{pyr_min, p, budget, stride, box_lo, box_hi, tail_flag, tally, next};
  cudaStream_t st = (cudaStream_t)stream;
  return counts != nullptr ? launch_mode<true>(mode, a, g, q, st)
                           : launch_mode<false>(mode, a, g, q, st);
}
