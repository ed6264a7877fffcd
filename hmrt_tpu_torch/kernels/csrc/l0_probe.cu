// A probe of the card, on no render path: what one step of the level-0
// tail costs when nothing hides its load.
//
// One lane walks `steps` cells of one ray's level-0 DDA with the level-0
// step of the tail (march_common.cuh, the torch `l0_step`: the cell's
// exit, its 16-byte corner record, the skip test and the exact test, the
// advance), but with no prefetch, and the next cell waits on this cell's
// test: a cell that hits is taken again, as the plain loop takes it
// (bench/latency.py). So each step is one dependent record load plus one
// cell test, and the walk's time over `steps` is their latency. Walked over
// the longest ray of a tail launch, ceil(steps / G) of them is the least
// time that G lanes a ray, one window of G cells after another, can take.
//
// The walk ends in the state the lane groups' march (cell by cell, to the
// floor) reaches after the same steps, so bench/latency.py holds it to the
// plain walk and to march_pass.

#include <cuda_runtime.h>

#include "march_common.cuh"

namespace {

__global__ void l0_probe_kernel(const float* __restrict__ rays, const float* __restrict__ t0,
                                const int* __restrict__ cell, Terrain g, int steps,
                                float box_lo, float box_hi, float* __restrict__ t_o,
                                int* __restrict__ i_o) {
  MarchRay r;
  r.ox = rays[0], r.oy = rays[1], r.oz = rays[2];
  r.dx = rays[3], r.dy = rays[4], r.dz = rays[5];
  r.inv_x = 1.0f / safe(r.dx);
  r.inv_y = 1.0f / safe(r.dy);
  float t_in;
  ray_box(r.ox, r.oy, r.inv_x, r.inv_y, box_lo, box_hi, t_in, r.t1);
  float t = t0[0], t_hit = BIG_T;
  int icx = cell[0], icy = cell[1], hit = 0, tests = 0;
  for (int st = 0; st < steps; ++st) {
    const CellExit e = cell_exit(r, icx, icy, 1.0f);
    const float t_exit_c = fminf(e.t, r.t1);
    const float zmin = r.oz + fminf(t * r.dz, t_exit_c * r.dz);
    const float4 c = cell_record(g, icx, icy);
    const float cmax = fmaxf(fmaxf(c.x, c.y), fmaxf(c.z, c.w));
    bool hit_now = false;
    float t_c = BIG_T;
    if (!(zmin > cmax)) {
      ++tests;
      intersect_cell(g.kind, r, icx, icy, c, t - T_TOL, t_exit_c + T_TOL, hit_now, t_c);
    }
    if (hit_now) {  // the next load waits on this: a hit stays in its cell
      hit = 1;
      t_hit = t_c;
    } else {
      icx = e.nx;
      icy = e.ny;
      t = fmaxf(t, t_exit_c);
    }
  }
  t_o[0] = t;
  t_o[1] = t_hit;
  i_o[0] = icx;
  i_o[1] = icy;
  i_o[2] = hit;
  i_o[3] = tests;
}

}  // namespace

// `rays` is one ray's (ox, oy, oz, dx, dy, dz) on the device, `t0` its t and
// `cell` its level-0 cell (icx, icy); `t_o` takes (t, t_hit) and `i_o`
// (icx, icy, hit, tests) after `steps` steps. One thread of one block.
extern "C" int hmrt_l0_probe(const float* rays, const float* t0, const int* cell,
                             const float* corners, int m, int intersector, int steps,
                             float box_lo, float box_hi, float* t_o, int* i_o, void* stream) {
  if (steps < 0 || m <= 0) return (int)cudaErrorInvalidValue;
  Terrain g{nullptr, reinterpret_cast<const float4*>(corners), m, 0, intersector};
  l0_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(rays, t0, cell, g, steps, box_lo, box_hi,
                                                     t_o, i_o);
  return (int)cudaGetLastError();
}
