// Normal and albedo at a hit point, shared by the shade pass
// (shade_pass.cu) and the fused tile kernel (render_tile.cu).
//
// For a hit in cell (hx, hy) at in-cell offsets (fx, fy): the bilinear
// interpolation of the central-difference gradients (gx, gy) at the cell's
// 4 corners gives the normal normalize(-gx, -gy, 1); a textured scene also
// gets the bilinear RGB albedo of the cell's 4 corners. A miss gets the
// normal (0, 0, 1) and albedo 0.55. The expressions are those of the torch
// plain version, in the same order, and the normalisation uses 1/sqrtf(x),
// not the approximate rsqrtf.
//
// The shade pass reads a cell's corners from its per-cell records
// (api/scene.py shade_records; shade_pass.cu); the fused kernel reads them
// from the gradient planes (N, N) and the planar (3, N*N) albedo
// (shade_lane). Both records and planes hold the same values.
//
// The colour of a pixel from its shade data (shade_color, at the end),
// shared by the colour pass (shade_color.cu) and the fused tile kernel.

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

// The shade data of a miss.
static __device__ __forceinline__ ShadeData miss_shade() {
  return ShadeData{0.0f, 0.0f, 1.0f, 0.55f, 0.55f, 0.55f};
}

// normalize(-g_x, -g_y, 1) into d.
static __device__ __forceinline__ void set_normal(ShadeData& d, float g_x, float g_y) {
  float inv = 1.0f / sqrtf(g_x * g_x + g_y * g_y + 1.0f);
  d.nx = -g_x * inv;
  d.ny = -g_y * inv;
  d.nz = inv;
}

// From the planes: 4-byte loads at the cell's corners on rows cy and cy+1.
static __device__ __forceinline__ ShadeData shade_lane(bool hit, int hx, int hy, float fx,
                                                       float fy, const float* gx,
                                                       const float* gy, const float* albedo,
                                                       int n) {
  ShadeData d = miss_shade();
  if (!hit) return d;
  int cx = min(max(hx, 0), n - 2);
  int cy = min(max(hy, 0), n - 2);
  long long b = (long long)cy * n + cx;
  set_normal(d, bilerp(gx[b], gx[b + 1], gx[b + n], gx[b + n + 1], fx, fy),
             bilerp(gy[b], gy[b + 1], gy[b + n], gy[b + n + 1], fx, fy));
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

// From a cell's records, already loaded: g = (g00x, g10x, g01x, g11x) and
// (g00y, g10y, g01y, g11y); a = (r00, r10, r01, r11), (g00, ...), (b00, ...).
static __device__ __forceinline__ ShadeData shade_records(const float4 g[2], const float4* a,
                                                          float fx, float fy) {
  ShadeData d = miss_shade();
  set_normal(d, bilerp(g[0].x, g[0].y, g[0].z, g[0].w, fx, fy),
             bilerp(g[1].x, g[1].y, g[1].z, g[1].w, fx, fy));
  if (a != nullptr) {
    d.ar = bilerp(a[0].x, a[0].y, a[0].z, a[0].w, fx, fy);
    d.ag = bilerp(a[1].x, a[1].y, a[1].z, a[1].w, fx, fy);
    d.ab = bilerp(a[2].x, a[2].y, a[2].z, a[2].w, fx, fy);
  }
  return d;
}

// The light's vectors, 3 floats each in device memory: the unit direction
// toward the sun, the sun's colour, the sky at the zenith and at the
// horizon, the fog's colour. Read by pointer, so a frame replayed from a
// CUDA graph reads the light as it is when it runs.
struct LightVecs {
  const float* sun;
  const float* sun_color;
  const float* sky_top;
  const float* sky_horizon;
  const float* fog_color;
};

// The config's colour settings (RenderConfig's fields).
struct ColorSettings {
  int phong, fog;
  float ambient, specular, shininess, fog_density;
};

// A pixel's outputs: its colour clipped to [0, 1], its depth (t on a hit,
// +inf on a miss) and its normal ((0, 0, 0) on a miss).
struct PixelColor {
  float r, g, b, depth, nx, ny, nz;
};

// The colour of a pixel from its shade data `d`, its primary direction
// (dx, dy, dz), its march result (hit, t_hit) and whether its shadow ray
// hit (`occ`): Lambert, Phong with V = -d, fog, the sky on a miss, the clip.
// The expressions and their order are those of the plain version
// (kernels/shade_color.py::shade_color_reference, shading/shade.py).
static __device__ __forceinline__ PixelColor shade_color(const ShadeData& d, float dx,
                                                         float dy, float dz, bool hit,
                                                         float t_hit, bool occ,
                                                         const LightVecs& L,
                                                         const ColorSettings& c) {
  const float ts = hit ? t_hit : 0.0f;
  const float lx = L.sun[0], ly = L.sun[1], lz = L.sun[2];
  float diff = fmaxf(d.nx * lx + d.ny * ly + d.nz * lz, 0.0f);
  if (occ) diff = 0.0f;

  const float sr = L.sun_color[0], sg = L.sun_color[1], sb = L.sun_color[2];
  float cr = d.ar * (c.ambient + diff * sr);
  float cg = d.ag * (c.ambient + diff * sg);
  float cb = d.ab * (c.ambient + diff * sb);
  if (c.phong) {
    // phong_specular with V = -d
    float ndl = d.nx * lx + d.ny * ly + d.nz * lz;
    float rx = 2.0f * ndl * d.nx - lx;
    float ry = 2.0f * ndl * d.ny - ly;
    float rz = 2.0f * ndl * d.nz - lz;
    float rdv = fmaxf(rx * -dx + ry * -dy + rz * -dz, 0.0f);
    float spec = ndl > 0.0f ? powf(rdv, c.shininess) : 0.0f;
    if (occ) spec = 0.0f;
    cr = cr + c.specular * spec * sr;
    cg = cg + c.specular * spec * sg;
    cb = cb + c.specular * spec * sb;
  }
  if (c.fog) {
    float f = expf(-ts * c.fog_density);
    cr = cr * f + L.fog_color[0] * (1 - f);
    cg = cg * f + L.fog_color[1] * (1 - f);
    cb = cb * f + L.fog_color[2] * (1 - f);
  }
  if (!hit) {
    float u = sqrtf(fminf(fmaxf(dz, 0.0f), 1.0f));
    cr = L.sky_horizon[0] * (1.0f - u) + L.sky_top[0] * u;
    cg = L.sky_horizon[1] * (1.0f - u) + L.sky_top[1] * u;
    cb = L.sky_horizon[2] * (1.0f - u) + L.sky_top[2] * u;
  }
  return PixelColor{fminf(fmaxf(cr, 0.0f), 1.0f),
                    fminf(fmaxf(cg, 0.0f), 1.0f),
                    fminf(fmaxf(cb, 0.0f), 1.0f),
                    hit ? t_hit : __int_as_float(0x7f800000),  // +inf
                    hit ? d.nx : 0.0f,
                    hit ? d.ny : 0.0f,
                    hit ? d.nz : 0.0f};
}
