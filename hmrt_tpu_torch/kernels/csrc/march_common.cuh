// The per-ray max-mip march, shared by the march pass (march_pass.cu) and
// the fused tile kernel (render_tile.cu).
//
// One thread marches one ray: `march_steps` takes up to `budget` steps of
// the max-mip march (the body of hmrt_tpu/traversal/march.py::march_maxmip
// without the cone branch, and of the torch `maxmip_step`), updating the
// ray's state and hit results in place. Every float expression is that of
// the torch step, in the same order; the build's -fmad=false,
// -prec-div=true and -prec-sqrt=true keep the bits, because a contracted
// multiply-add or an approximate division moves a grazing hit by an ulp and
// flips it.
//
// Everything here is `static`: each .cu file is its own translation unit
// (no -rdc) and gets its own inlined copy.

#pragma once

#include <cuda_runtime.h>

static constexpr float BIG_T = 3.0e38f;
static constexpr float EPS_EXIT = 1.0e-6f;
static constexpr float T_TOL = 1.0e-3f;
static constexpr float TINY = 1.0e-20f;
// containment slack of the intersectors, formed in double as the Python
// expressions `1.0 + eps` and `1.0 - eps` are, then rounded once
static constexpr float EPS_IN = 1.0e-6f;
static constexpr float ONE_PLUS_EPS = (float)(1.0 + 1.0e-6);
static constexpr float ONE_MINUS_EPS = (float)(1.0 - 1.0e-6);
// the step budget that resolves every ray (march_pass.py UNBUDGETED)
static constexpr int UNBUDGETED = 1 << 22;

enum Intersector { TRIANGLE = 0, BILINEAR = 1, FLAT = 2 };

// A ray and what the march derives from it once.
struct MarchRay {
  float ox, oy, oz, dx, dy, dz;
  float inv_x, inv_y;  // 1 / safe(dx), 1 / safe(dy)
  float t1;            // exit t of the terrain box (or the clip window)
};

// Per-ray march state and hit results (the planes of march_pass.py).
struct MarchState {
  int alive;
  float t;
  int lvl, icx, icy;
  int hit;
  float t_hit;
  int hx, hy;
};

// What the march reads: the flat level-major max pyramid and the heights.
struct Terrain {
  const float* pyr;
  const float* heights;
  int n, m, levels, kind;
  float gmax;  // the pyramid top
};

static __device__ __forceinline__ float safe(float x) { return fabsf(x) < TINY ? TINY : x; }

static __device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Flat index of the pyramid top: the last entry of a pyramid over m x m.
static __device__ __forceinline__ long long pyramid_top(int m) {
  long long mm = (long long)m * m;
  return (mm * 4 - 1) / 3 - 1;
}

// ray_box_range: entry t0 (clamped at 0) and exit t1 of the slab
// [lo, hi]^2; the ray is inside when t1 > t0.
static __device__ __forceinline__ void ray_box(float ox, float oy, float inv_x, float inv_y,
                                               float lo, float hi, float& t0, float& t1) {
  float tx0 = (lo - ox) * inv_x, tx1 = (hi - ox) * inv_x;
  float ty0 = (lo - oy) * inv_y, ty1 = (hi - oy) * inv_y;
  t0 = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), 0.0f);
  t1 = fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1));
}

static __device__ __forceinline__ void intersect_triangles(
    float ox, float oy, float oz, float dx, float dy, float dz, int cx, int cy, float z00,
    float z10, float z01, float z11, float t_lo, float t_hi, bool& hit, float& t) {
  float fx = (float)cx;
  float fy = (float)cy;
  float g1x = z10 - z00;
  float g1y = z01 - z00;
  float denom1 = dz - g1x * dx - g1y * dy;
  float num1 = z00 + g1x * (ox - fx) + g1y * (oy - fy) - oz;
  float t1 = num1 / safe(denom1);
  float u1 = ox + t1 * dx - fx;
  float v1 = oy + t1 * dy - fy;
  bool ok1 = (u1 >= -EPS_IN) && (v1 >= -EPS_IN) && (u1 + v1 <= ONE_PLUS_EPS) &&
             (t1 >= t_lo) && (t1 <= t_hi);

  float a2 = z10 - z11 + z01;
  float g2x = z11 - z01;
  float g2y = z11 - z10;
  float denom2 = dz - g2x * dx - g2y * dy;
  float num2 = a2 + g2x * (ox - fx) + g2y * (oy - fy) - oz;
  float t2 = num2 / safe(denom2);
  float u2 = ox + t2 * dx - fx;
  float v2 = oy + t2 * dy - fy;
  bool ok2 = (u2 <= ONE_PLUS_EPS) && (v2 <= ONE_PLUS_EPS) && (u2 + v2 >= ONE_MINUS_EPS) &&
             (t2 >= t_lo) && (t2 <= t_hi);

  hit = ok1 || ok2;
  t = fminf(ok1 ? t1 : BIG_T, ok2 ? t2 : BIG_T);
}

static __device__ __forceinline__ void intersect_bilinear(
    float ox, float oy, float oz, float dx, float dy, float dz, int cx, int cy, float z00,
    float z10, float z01, float z11, float t_lo, float t_hi, bool& hit, float& t) {
  float fx = (float)cx;
  float fy = (float)cy;
  float b = z10 - z00;
  float c = z01 - z00;
  float e = z11 - z10 - z01 + z00;
  float u0 = ox - fx;
  float v0 = oy - fy;
  float A = -e * dx * dy;
  float B = dz - b * dx - c * dy - e * (u0 * dy + v0 * dx);
  float C = oz - z00 - b * u0 - c * v0 - e * u0 * v0;
  float lin_t = -C / safe(B);
  float disc = B * B - 4.0f * A * C;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float q = -0.5f * (B + sign_of(B) * sq);
  float r1 = q / safe(A);
  float r2 = C / safe(q);
  float tmin = fminf(r1, r2);
  float tmax = fmaxf(r1, r2);
  bool is_lin = fabsf(A) < 1.0e-12f;

  auto valid_lin = [&](float tt) {
    float u = u0 + tt * dx;
    float v = v0 + tt * dy;
    return (u >= -EPS_IN) && (u <= ONE_PLUS_EPS) && (v >= -EPS_IN) &&
           (v <= ONE_PLUS_EPS) && (tt >= t_lo) && (tt <= t_hi);
  };
  bool vmin = valid_lin(tmin) && (disc >= 0.0f);
  bool vmax = valid_lin(tmax) && (disc >= 0.0f);
  bool vlin = valid_lin(lin_t);
  hit = (is_lin && vlin) || (!is_lin && vmin) || (!is_lin && vmax);
  float tq = vmin ? tmin : (vmax ? tmax : BIG_T);
  t = is_lin ? (vlin ? lin_t : BIG_T) : tq;
}

static __device__ __forceinline__ void intersect_flat(float ox, float oy, float oz, float dx,
                                                      float dy, float dz, float z00, float z10,
                                                      float z01, float z11, float t_lo,
                                                      float t_hi, bool& hit, float& t) {
  float zmax = fmaxf(fmaxf(z00, z10), fmaxf(z01, z11));
  bool wall = oz + t_lo * dz <= zmax;
  float t_top = (zmax - oz) / safe(dz);
  bool top = (dz < 0.0f) && (t_top >= t_lo) && (t_top <= t_hi);
  hit = wall || top;
  t = wall ? t_lo : t_top;
}

static __device__ __forceinline__ int ascent_levels(int b) {
  return ((b & 1) == 0) + ((b & 3) == 0) + ((b & 7) == 0);
}

// Up to `budget` max-mip steps of one ray; a ray that is not alive is left
// as it is. Each step reads one pyramid cell, and at level 0 the 4 corner
// heights of the cell when the max does not let the ray skip it.
static __device__ __forceinline__ void march_steps(const MarchRay& r, MarchState& s,
                                                   int budget, const Terrain& g) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float inv_x = r.inv_x, inv_y = r.inv_y, t1 = r.t1;
  const int n = g.n, m = g.m, levels = g.levels;
  const long long mm = (long long)m * m;
  int alive = s.alive;
  float t = s.t;
  int lvl = s.lvl, icx = s.icx, icy = s.icy;

  for (int st = 0; st < budget && alive; ++st) {
    // step_geometry
    float side_f = (float)(1 << lvl);
    bool pos_x = dx > 0.0f, pos_y = dy > 0.0f;
    int bx = icx + (pos_x ? 1 : 0);
    int by = icy + (pos_y ? 1 : 0);
    float tx = ((float)bx * side_f - ox) * inv_x;
    float ty = ((float)by * side_f - oy) * inv_y;
    if (fabsf(dx) < TINY) tx = BIG_T;
    if (fabsf(dy) < TINY) ty = BIG_T;
    bool axis_x = tx <= ty;
    float t_exit = fminf(tx, ty);
    int nx = axis_x ? icx + (pos_x ? 1 : -1) : icx;
    int ny = axis_x ? icy : icy + (pos_y ? 1 : -1);
    int bnd = axis_x ? bx : by;

    float t_exit_c = fminf(t_exit, t1);
    float zmin = oz + fminf(t * dz, t_exit_c * dz);

    int side = m >> lvl;
    int cyc = min(max(icy, 0), side - 1);
    int cxc = min(max(icx, 0), side - 1);
    long long off = ((mm - (mm >> (2 * lvl))) * 4) / 3;
    float cmax = g.pyr[off + (long long)cyc * side + cxc];

    bool skip = zmin > cmax;
    bool at_fine = lvl == 0;
    bool descend = !skip && !at_fine;
    bool hit_now = false;
    float t_c = BIG_T;
    if (!skip && at_fine) {
      int cx = min(max(icx, 0), n - 2);
      int cy = min(max(icy, 0), n - 2);
      long long base = (long long)cy * n + cx;
      float z00 = g.heights[base], z10 = g.heights[base + 1];
      float z01 = g.heights[base + n], z11 = g.heights[base + n + 1];
      float t_lo = t - T_TOL, t_hi = t_exit_c + T_TOL;
      if (g.kind == TRIANGLE)
        intersect_triangles(ox, oy, oz, dx, dy, dz, icx, icy, z00, z10, z01, z11, t_lo, t_hi,
                            hit_now, t_c);
      else if (g.kind == BILINEAR)
        intersect_bilinear(ox, oy, oz, dx, dy, dz, icx, icy, z00, z10, z01, z11, t_lo, t_hi,
                           hit_now, t_c);
      else
        intersect_flat(ox, oy, oz, dx, dy, dz, z00, z10, z01, z11, t_lo, t_hi, hit_now, t_c);
    }

    if (hit_now) {
      alive = 0;
      s.hit = 1;
      s.t_hit = t_c;
      s.hx = icx;
      s.hy = icy;
    } else if (descend) {
      // descend_cell: the child containing the position at t
      float s_child = (float)(1 << (lvl - 1));
      float px = ox + t * dx;
      float py = oy + t * dy;
      int cx2 = 2 * icx, cy2 = 2 * icy;
      icx = cx2 + (px >= (float)(cx2 + 1) * s_child ? 1 : 0);
      icy = cy2 + (py >= (float)(cy2 + 1) * s_child ? 1 : 0);
      lvl = lvl - 1;
    } else {
      // advance, ascending on a skip by the crossed boundary's alignment
      int asc = skip ? ascent_levels(bnd) : 0;
      asc = min(asc, (levels - 1) - lvl);
      lvl = lvl + asc;
      icx = nx >> asc;  // arithmetic shift: nx may be -1
      icy = ny >> asc;
      t = fmaxf(t, t_exit_c);
      int new_side = m >> lvl;
      bool escaped = (oz + t * dz > g.gmax) && (dz > 0.0f);
      bool out = (t_exit >= t1 - EPS_EXIT) || icx < 0 || icx >= new_side || icy < 0 ||
                 icy >= new_side || escaped;
      if (out) alive = 0;
    }
  }
  s.alive = alive;
  s.t = t;
  s.lvl = lvl;
  s.icx = icx;
  s.icy = icy;
}
