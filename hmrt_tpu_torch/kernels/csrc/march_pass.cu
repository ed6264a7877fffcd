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
// What bounds it on the H100: the steps themselves. A B3 frame takes 2.2
// billion steps, 99% of them level-0 cell tests with two IEEE divisions
// each; the kernel takes about 6x its operations bound, and the sorted rays
// keep 98% of a warp's lanes busy even without refill (PERF.md,
// chip_smoke.py phase 10). Of what was measured, more warps per SM (fewer
// registers) helped; deeper prefetch and fewer instructions per step did
// not. What this design does:
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
// before the tail run keeps its registers: MODE_L0 marches the level-0 DDA
// with the exact test (march_steps' L0 instance, with its prefetch ring),
// MODE_RELAX the relaxed stride tail (relaxed_steps, one record load a step,
// not tuned). With a tail flag (the compact path's "auto" tail, decided on
// the device) a tail instance reads it once and, when it is 0, runs the
// max-mip march instead: a uniform branch, no host wait.

#include <cuda_runtime.h>

#include "march_common.cuh"

namespace {

constexpr int THREADS = 64;
// steps a lane marches between two looks at the queue (each look drops the
// prefetch ring)
constexpr int CHUNK = 256;
// idle lanes of a warp that make it claim new rays
constexpr int REFILL_MIN = 32;
// blocks an SM must hold at once: caps the registers a thread may use
// (1: no cap; a cap that buys more warps made ptxas spill)
constexpr int MIN_BLOCKS = 1;
// what a pass marches (march_pass.py MODE_*)
constexpr int MODE_MAXMIP = 0, MODE_L0 = 1, MODE_RELAX = 2;

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

template <bool COUNT, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    march_pass_kernel(const Planes a, const Terrain g, int p, int budget, int stride,
                      float box_lo, float box_hi, const int* tail_flag, int* next) {
  const float gmax = __ldg(g.pyr + pyramid_top(g.m));
  // the tail instances run their tail unless the flag says otherwise
  const bool tail = MODE != MODE_MAXMIP && (tail_flag == nullptr || __ldg(tail_flag) != 0);
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
      if (s.alive) {
        r.ox = a.ox[i], r.oy = a.oy[i], r.oz = a.oz[i];
        r.dx = a.dx[i], r.dy = a.dy[i], r.dz = a.dz[i];
        // ray_inverses / ray_box_range (only the exit t1 is needed here)
        r.inv_x = 1.0f / safe(r.dx);
        r.inv_y = 1.0f / safe(r.dy);
        float t0;
        ray_box(r.ox, r.oy, r.inv_x, r.inv_y, box_lo, box_hi, t0, r.t1);
      }
    }
    if (!__any_sync(FULL_WARP, i >= 0)) break;  // a warp with no ray has claimed past p

    if (i >= 0) {
      MarchHit h{0, BIG_T, 0, 0};
      const int steps = min(CHUNK, budget - used);
      if (MODE == MODE_RELAX && tail)
        used += relaxed_steps<COUNT>(r, s, h, steps, g, gmax, stride, w);
      else if (MODE == MODE_L0 && tail)
        used += march_steps<COUNT, true>(r, s, h, steps, g, gmax, w);
      else
        used += march_steps<COUNT>(r, s, h, steps, g, gmax, w);
      if (!s.alive || used >= budget) {
        a.alive_o[i] = s.alive;
        a.t_o[i] = s.t;
        a.lvl_o[i] = s.lvl;
        a.icx_o[i] = s.icx;
        a.icy_o[i] = s.icy;
        // a ray that hit in this pass ends in its last chunk; any other
        // keeps the results it came with
        a.hit_o[i] = h.hit ? 1 : a.hit[i];
        a.t_hit_o[i] = h.hit ? h.t_hit : a.t_hit[i];
        a.hx_o[i] = h.hit ? h.hx : a.hx[i];
        a.hy_o[i] = h.hit ? h.hy : a.hy[i];
        if (COUNT) {
          a.counts[i] = w.steps;
          a.counts[(long long)p + i] = w.tests;
        }
        i = -1;
      }
    }
  }
}

template <bool COUNT, int MODE>
int launch(const Planes& a, const Terrain& g, int p, int budget, int stride, float box_lo,
           float box_hi, const int* tail_flag, int* next, cudaStream_t stream) {
  const int blocks = persistent_blocks(march_pass_kernel<COUNT, MODE>, THREADS, p);
  march_pass_kernel<COUNT, MODE><<<blocks, THREADS, 0, stream>>>(a, g, p, budget, stride, box_lo,
                                                                   box_hi, tail_flag, next);
  return (int)cudaGetLastError();
}

template <bool COUNT>
int launch_mode(int mode, const Planes& a, const Terrain& g, int p, int budget, int stride,
                float box_lo, float box_hi, const int* tail_flag, int* next,
                cudaStream_t stream) {
  if (mode == MODE_L0)
    return launch<COUNT, MODE_L0>(a, g, p, budget, stride, box_lo, box_hi, tail_flag, next,
                                  stream);
  if (mode == MODE_RELAX)
    return launch<COUNT, MODE_RELAX>(a, g, p, budget, stride, box_lo, box_hi, tail_flag, next,
                                     stream);
  return launch<COUNT, MODE_MAXMIP>(a, g, p, budget, stride, box_lo, box_hi, tail_flag, next,
                                    stream);
}

}  // namespace

// `mode` is MODE_MAXMIP, MODE_L0 or MODE_RELAX (then `stride` > 0 cells and
// an unbudgeted pass); `tail_flag` is null (a tail mode always runs its tail)
// or one int32 on the device. `next` is a zeroed int32 on the device (the ray
// counter); `counts` is null or an int32 (2, p) plane that takes each ray's
// steps and cell tests. An unknown mode, or a relaxed pass with a budget or
// no stride, returns cudaErrorInvalidValue and launches nothing.
extern "C" int hmrt_march_pass(const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const int* alive, const float* t, const int* lvl,
                               const int* icx, const int* icy, const int* hit,
                               const float* t_hit, const int* hx, const int* hy,
                               int* alive_o, float* t_o, int* lvl_o, int* icx_o,
                               int* icy_o, int* hit_o, float* t_hit_o, int* hx_o,
                               int* hy_o, const float* pyr_flat, const float* corners, int p,
                               int m, int levels, int budget, int intersector, int mode,
                               int stride, float box_lo, float box_hi, const int* tail_flag,
                               int* next, int* counts, void* stream) {
  if (mode < MODE_MAXMIP || mode > MODE_RELAX ||
      (mode == MODE_RELAX && (stride <= 0 || budget != UNBUDGETED)))
    return (int)cudaErrorInvalidValue;
  if (p <= 0) return (int)cudaSuccess;
  Planes a{ox,    oy,    oz,    dx,   dy,   dz,   alive,   t,     lvl,  icx,
           icy,   hit,   t_hit, hx,   hy,   alive_o, t_o,  lvl_o, icx_o, icy_o,
           hit_o, t_hit_o, hx_o, hy_o, counts};
  Terrain g{pyr_flat, reinterpret_cast<const float4*>(corners), m, levels, intersector};
  cudaStream_t st = (cudaStream_t)stream;
  return counts != nullptr
             ? launch_mode<true>(mode, a, g, p, budget, stride, box_lo, box_hi, tail_flag, next, st)
             : launch_mode<false>(mode, a, g, p, budget, stride, box_lo, box_hi, tail_flag, next,
                                  st);
}
