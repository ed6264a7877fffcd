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
// the pyramid and the height grid are read with plain global loads.
//
// What bounds it on the H100: one thread per ray walks a chain of
// dependent global loads (cell max -> skip test -> next cell), so the pass
// is latency- and divergence-bound, not bound by bytes or operations: rays
// of one warp take different numbers of steps and visit scattered cells.
// What this design does about it: nothing yet, on purpose. It is the
// simple, exact version; the sorted rounds of the caller keep the rays of
// a block in nearby terrain columns, and faster layouts (corner float4s,
// persistent blocks) are later work measured against this one.
//
// The step itself is `march_steps` of march_common.cuh, shared with the
// fused tile kernel; its float expressions are those of the torch and JAX
// march, in the same order.

#include <cuda_runtime.h>

#include "march_common.cuh"

namespace {

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
  const float* pyr;
  const float* heights;
};

__global__ void march_pass_kernel(Planes a, int p, int n, int m, int levels, int budget,
                                  int kind, float box_lo, float box_hi) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;

  MarchState s{a.alive[i], a.t[i],     a.lvl[i], a.icx[i], a.icy[i],
               a.hit[i],   a.t_hit[i], a.hx[i],  a.hy[i]};
  if (s.alive) {
    MarchRay r;
    r.ox = a.ox[i], r.oy = a.oy[i], r.oz = a.oz[i];
    r.dx = a.dx[i], r.dy = a.dy[i], r.dz = a.dz[i];
    // ray_inverses / ray_box_range (only the exit t1 is needed here)
    r.inv_x = 1.0f / safe(r.dx);
    r.inv_y = 1.0f / safe(r.dy);
    float t0;
    ray_box(r.ox, r.oy, r.inv_x, r.inv_y, box_lo, box_hi, t0, r.t1);
    Terrain g{a.pyr, a.heights, n, m, levels, kind, a.pyr[pyramid_top(m)]};
    march_steps(r, s, budget, g);
  }

  a.alive_o[i] = s.alive;
  a.t_o[i] = s.t;
  a.lvl_o[i] = s.lvl;
  a.icx_o[i] = s.icx;
  a.icy_o[i] = s.icy;
  a.hit_o[i] = s.hit;
  a.t_hit_o[i] = s.t_hit;
  a.hx_o[i] = s.hx;
  a.hy_o[i] = s.hy;
}

}  // namespace

extern "C" int hmrt_march_pass(const float* ox, const float* oy, const float* oz,
                               const float* dx, const float* dy, const float* dz,
                               const int* alive, const float* t, const int* lvl,
                               const int* icx, const int* icy, const int* hit,
                               const float* t_hit, const int* hx, const int* hy,
                               int* alive_o, float* t_o, int* lvl_o, int* icx_o,
                               int* icy_o, int* hit_o, float* t_hit_o, int* hx_o,
                               int* hy_o, const float* pyr_flat, const float* heights, int p,
                               int n, int m, int levels, int budget, int intersector,
                               float box_lo, float box_hi, void* stream) {
  if (p <= 0) return (int)cudaSuccess;
  Planes a{ox,    oy,   oz,    dx,    dy,    dz,    alive, t,       lvl,  icx,
           icy,   hit,  t_hit, hx,    hy,    alive_o, t_o, lvl_o,   icx_o, icy_o,
           hit_o, t_hit_o, hx_o, hy_o, pyr_flat, heights};
  const int threads = 256;
  march_pass_kernel<<<(p + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      a, p, n, m, levels, budget, intersector, box_lo, box_hi);
  return (int)cudaGetLastError();
}
