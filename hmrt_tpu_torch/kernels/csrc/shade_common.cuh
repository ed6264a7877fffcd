// Normal and albedo at a hit point, shared by the shade pass
// (shade_pass.cu) and the fused tile kernel (render_tile.cu).
//
// For a hit in cell (hx, hy) at in-cell offsets (fx, fy): the bilinear
// interpolation of the central-difference gradients (gx, gy) at the cell's
// 4 corners gives the normal normalize(-gx, -gy, 1); a textured scene also
// gets the bilinear RGB albedo from the planar (3, N*N) texture. A miss
// gets the normal (0, 0, 1) and albedo 0.55. The expressions are those of
// the torch plain version, in the same order, and the normalisation uses
// 1/sqrtf(x), not the approximate rsqrtf.

#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ float bilerp(float v00, float v10, float v01, float v11,
                                               float fx, float fy) {
  return v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy) + v01 * (1 - fx) * fy +
         v11 * fx * fy;
}

struct ShadeData {
  float nx, ny, nz, ar, ag, ab;
};

static __device__ __forceinline__ ShadeData shade_lane(bool hit, int hx, int hy, float fx,
                                                       float fy, const float* gx,
                                                       const float* gy, const float* albedo,
                                                       int n) {
  ShadeData d{0.0f, 0.0f, 1.0f, 0.55f, 0.55f, 0.55f};
  if (!hit) return d;
  int cx = min(max(hx, 0), n - 2);
  int cy = min(max(hy, 0), n - 2);
  long long b = (long long)cy * n + cx;
  float g_x = bilerp(gx[b], gx[b + 1], gx[b + n], gx[b + n + 1], fx, fy);
  float g_y = bilerp(gy[b], gy[b + 1], gy[b + n], gy[b + n + 1], fx, fy);
  float inv = 1.0f / sqrtf(g_x * g_x + g_y * g_y + 1.0f);
  d.nx = -g_x * inv;
  d.ny = -g_y * inv;
  d.nz = inv;
  if (albedo != nullptr) {
    long long nn = (long long)n * n;
    const float* r = albedo;
    const float* g = albedo + nn;
    const float* bl = albedo + 2 * nn;
    d.ar = bilerp(r[b], r[b + 1], r[b + n], r[b + n + 1], fx, fy);
    d.ag = bilerp(g[b], g[b + 1], g[b + n], g[b + n + 1], fx, fy);
    d.ab = bilerp(bl[b], bl[b + 1], bl[b + n], bl[b + n + 1], fx, fy);
  }
  return d;
}
