// The per-ray max-mip march, shared by the march pass (march_pass.cu) and
// the fused tile kernel (render_tile.cu), and the warp-level work queue both
// of them run on.
//
// One thread marches one ray: `march_steps` takes up to `budget` steps of
// the max-mip march (the body of hmrt_tpu/traversal/march.py::march_maxmip
// without the cone branch, and of the torch `maxmip_step`), updating the
// ray's state and hit results in place. `l0_min_steps` is the
// forced-level-0 tail (the torch `l0_min_step`): the hits of the level-0
// walk of hmrt_tpu/kernels/march_body.py::wavefront_step_l0 (the torch
// `l0_step`), but a ray under the terrain passes whole blocks of the min
// pyramid untested and ends under the map's lowest height (see below).
// `relaxed_steps` is the relaxed stride tail (`l0_step_relaxed`,
// march_body.py::wavefront_step_l0_relaxed). Every float expression is that of
// the torch step, in the same order; the build's -fmad=false,
// -prec-div=true and -prec-sqrt=true keep the bits, because a contracted
// multiply-add or an approximate division moves a grazing hit by an ulp and
// flips it.
//
// What the march reads. A level-0 cell is one 16-byte corner record
// (Scene.corners, core/pyramid.py corner_records): its four corner heights
// in the intersectors' order, NEG_INF on padded cells. The step takes the
// cell's max from it (the max of the four, which is pyramid level 0 bit for
// bit) and the exact test from the same registers: one load per level-0
// step instead of two dependent ones (the cell's max, then its heights).
// Levels >= 1 read the flat pyramid.
//
// Prefetched level-0 runs. While a ray stays at level 0, the cells it
// visits next follow from its geometry alone (the level-0 DDA: no loaded
// value enters them), and a level-0 step that does not end the ray either
// ascends or moves to exactly that next cell. So the march keeps the
// records of the next RING cells in registers and issues each load RING
// steps before the step that tests it. RING = 2 was measured on the H100
// (PERF.md, kernel_times.py): deeper rings cost registers, and so warps,
// and were no faster (3 and 4 even, 5 to 8 slower). The step loop is
// unrolled RING times so that every ring slot is a fixed register: a
// rotating index would put
// the ring in local memory, and shifting the ring down would wait on each
// pending load. The cells are still tested one at a time, in order, by the
// same step; the ring changes when a load is issued, never what is
// computed. A hit, an ascent or the end of the ray drops the ring, and the
// loads still in flight are wasted.
//
// The level-0 tail by lane groups (`l0_group_steps`). The same fact lets G
// lanes test G consecutive cells of ONE ray at once: the k-th cell of the
// level-0 DDA is the k-th element of the merge of the x- and y-boundary
// exit sequences (each non-decreasing in f32: `(float)b` is exact, and a
// subtraction and a product by a fixed-sign factor round monotonically),
// taken x first on a tie as `cell_exit` takes it. A cell's skip, exact and
// out tests depend only on the ray, the cell, its exit and the running t,
// and that t is the running fmaxf of the earlier cells' exits (exact and
// associative), so a prefix max over the window gives each lane its t. A
// ballot then finds the first cell that ends the ray. Every float
// expression is the serial step's, so the bits are the serial march's.
//
// The level-0 tail under the terrain (`l0_min_steps`). Most of a tail's
// rays entered the map's wall below the surface and march beneath it to the
// far edge without a hit: every cell a step and an exact test whose answer
// is already known, since a ray that stays below a cell's lowest corner
// over the test window cannot meet the triangles or the patch, which lie
// between the corners. So the tail keeps the level-0 cell the walk stands
// in and a level `lvl` of the block around it it takes in one step: at
// level 0 the walk's own step, except that a cell the ray passes under by
// the margin (below_margins) is not tested; at level k >= 1 a block the ray
// passes under is left in one step, to the level-0 cell the walk enters
// there (block_crossing), else the step descends a level. A ray that
// passes under a cell or a block ascends by the crossed boundary's
// alignment, as the max-mip march does after a skip; and a descending ray
// under the map's lowest height, less the margin, ends. Exits are taken from
// the origin at integer boundaries, and the running t is the max of the
// exits, so every cell the tail still tests sees the walk's window, bit for
// bit: the hits are the walk's. A ray that ends as a miss ends elsewhere.
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
// the margin of the tests under the terrain (traversal/march.py MARGIN_*),
// each formed in double as the Python constants are, then rounded once
static constexpr float MARGIN_TOL = (float)(1.0e-3 * (1.0 + 1.0 / 1024.0));
static constexpr float MARGIN_Z = 1.0f / 524288.0f;  // 2^-19
static constexpr float MARGIN_S = (float)8.0e-6;
static constexpr float MARGIN_A = 1.0f / 524288.0f;
static constexpr float MARGIN_SAFE = (float)4.0e-20;
static constexpr float MARGIN_LIN = (float)2.0e-12;
static constexpr float MARGIN_A2 = 1.0f / 524288.0f;
// level-0 records kept in flight per ray (see above; measured)
static constexpr int RING = 2;
static constexpr unsigned FULL_WARP = 0xffffffffu;

enum Intersector { TRIANGLE = 0, BILINEAR = 1, FLAT = 2 };

// A ray and what the march derives from it once.
struct MarchRay {
  float ox, oy, oz, dx, dy, dz;
  float inv_x, inv_y;  // 1 / safe(dx), 1 / safe(dy)
  float t1;            // exit t of the terrain box (or the clip window)
};

// Per-ray march state (the state planes of march_pass.py). The relaxed tail
// adds its own three per ray (traversal/march.py relaxed_planes): the mode
// (0 stride sampling, 1 the exact walk over a bracket), the t of the last
// sample above the surface and the bracket's end. They live here so that
// they survive the persistent kernel's chunks of steps; the other marches
// never read them.
struct MarchState {
  int alive;
  float t;
  int lvl, icx, icy;
  int rmode = 0;
  float tprev = 0.0f, wend = BIG_T;
};

// A hit (the result planes of march_pass.py), set by the step that finds
// it. A hit ends the ray, so callers keep one per chunk of steps.
struct MarchHit {
  int hit;
  float t_hit;
  int hx, hy;
};

// What the march reads: the flat level-major max pyramid (levels >= 1) and
// the (m, m) level-0 corner records.
struct Terrain {
  const float* __restrict__ pyr;
  const float4* __restrict__ corners;
  int m, levels, kind;
};

// What a counting instance records per ray: steps taken and exact cell
// tests (the per-lane form of traversal/march.py WorkCounter).
struct Work {
  int steps, tests;
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

// The exact test of cell (cx, cy) with corner record c by the intersector
// `kind` (an Intersector).
static __device__ __forceinline__ void intersect_cell(int kind, const MarchRay& r, int cx,
                                                      int cy, float4 c, float t_lo, float t_hi,
                                                      bool& hit, float& t) {
  if (kind == TRIANGLE)
    intersect_triangles(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, cx, cy, c.x, c.y, c.z, c.w, t_lo,
                        t_hi, hit, t);
  else if (kind == BILINEAR)
    intersect_bilinear(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, cx, cy, c.x, c.y, c.z, c.w, t_lo,
                       t_hi, hit, t);
  else
    intersect_flat(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, c.x, c.y, c.z, c.w, t_lo, t_hi, hit, t);
}

// The height of each intersector's own cell surface at local (u, v), for the
// relaxed tail's samples (traversal/intersect.py surface_*): a sample below
// it implies a crossing that the matching intersector finds.
static __device__ __forceinline__ float surface_triangle(float u, float v, float z00, float z10,
                                                         float z01, float z11) {
  float zl = z00 + (z10 - z00) * u + (z01 - z00) * v;
  float zu = (z10 - z11 + z01) + (z11 - z01) * u + (z11 - z10) * v;
  return u + v <= 1.0f ? zl : zu;
}

static __device__ __forceinline__ float surface_bilinear(float u, float v, float z00, float z10,
                                                         float z01, float z11) {
  float b = z10 - z00;
  float c = z01 - z00;
  float e = z11 - z10 - z01 + z00;
  return z00 + b * u + c * v + e * u * v;
}

static __device__ __forceinline__ float surface_flat(float z00, float z10, float z01, float z11) {
  return fmaxf(fmaxf(z00, z10), fmaxf(z01, z11));
}

static __device__ __forceinline__ float surface_cell(int kind, float u, float v, float4 c) {
  if (kind == TRIANGLE) return surface_triangle(u, v, c.x, c.y, c.z, c.w);
  if (kind == BILINEAR) return surface_bilinear(u, v, c.x, c.y, c.z, c.w);
  return surface_flat(c.x, c.y, c.z, c.w);
}

// floor(x) clamped to [0, m-1], as an integer cell (traversal/march.py
// floor_cell); clamped as a float first, so every x converts.
static __device__ __forceinline__ int floor_cell(float x, int m) {
  return (int)fminf(fmaxf(floorf(x), 0.0f), (float)(m - 1));
}

static __device__ __forceinline__ int ascent_levels(int b) {
  return ((b & 1) == 0) + ((b & 3) == 0) + ((b & 7) == 0);
}

// step_geometry: the exit t of cell (icx, icy) of side `side_f`, the
// neighbour cell across that exit and the crossed boundary index. The
// level-0 prefetch calls it with side 1, the value (float)(1 << 0) the step
// passes at level 0, so both find the same next cell.
struct CellExit {
  float t;
  int nx, ny, bnd;
};

static __device__ __forceinline__ CellExit cell_exit(const MarchRay& r, int icx, int icy,
                                                     float side_f) {
  bool pos_x = r.dx > 0.0f, pos_y = r.dy > 0.0f;
  int bx = icx + (pos_x ? 1 : 0);
  int by = icy + (pos_y ? 1 : 0);
  float tx = ((float)bx * side_f - r.ox) * r.inv_x;
  float ty = ((float)by * side_f - r.oy) * r.inv_y;
  if (fabsf(r.dx) < TINY) tx = BIG_T;
  if (fabsf(r.dy) < TINY) ty = BIG_T;
  bool axis_x = tx <= ty;
  CellExit e;
  e.t = fminf(tx, ty);
  e.nx = axis_x ? icx + (pos_x ? 1 : -1) : icx;
  e.ny = axis_x ? icy : icy + (pos_y ? 1 : -1);
  e.bnd = axis_x ? bx : by;
  return e;
}

// The corner record of level-0 cell (cx, cy), clamped into the grid as the
// pyramid read is, through the read-only path.
static __device__ __forceinline__ float4 cell_record(const Terrain& g, int cx, int cy) {
  cx = min(max(cx, 0), g.m - 1);
  cy = min(max(cy, 0), g.m - 1);
  return __ldg(g.corners + ((long long)cy * g.m + cx));
}

// Up to `budget` max-mip steps of one ray; a ray that is not alive is left
// as it is. A hit ends the ray and sets `h`. `gmax` is the pyramid top.
// Returns the steps taken. COUNT instances add them, and the exact cell
// tests, to `w`.
template <bool COUNT>
static __device__ __forceinline__ int march_steps(const MarchRay& r, MarchState& s, MarchHit& h,
                                                  int budget, const Terrain& g, float gmax,
                                                  Work& w) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float t1 = r.t1;
  const int m = g.m, levels = g.levels;
  const long long mm = (long long)m * m;
  int alive = s.alive;
  float t = s.t;
  int lvl = s.lvl, icx = s.icx, icy = s.icy;

  float4 q[RING];      // records of the current level-0 cell and the next ones
  int qx = 0, qy = 0;  // the cell of the last record issued
  bool ring = false;   // q is live: this step's cell is at level 0 and its record is in q
  int st = 0;
  while (st < budget && alive) {
    // slot j of the ring is the record of the cell of the step j (mod RING)
    // steps into the run; each slot is issued RING steps before it is read
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      if (st >= budget || !alive) break;
      const CellExit e = cell_exit(r, icx, icy, (float)(1 << lvl));
      float t_exit_c = fminf(e.t, t1);
      float zmin = oz + fminf(t * dz, t_exit_c * dz);

      const bool at_fine = lvl == 0;
      float cmax;
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (at_fine) {
        if (!ring) {  // entering a level-0 run: issue this cell and the next RING-1
          qx = icx;
          qy = icy;
          q[j] = cell_record(g, qx, qy);
#pragma unroll
          for (int k = 1; k < RING; ++k) {
            const CellExit f = cell_exit(r, qx, qy, 1.0f);
            qx = f.nx;
            qy = f.ny;
            q[(j + k) % RING] = cell_record(g, qx, qy);
          }
          ring = true;
        }
        c = q[j];
        cmax = fmaxf(fmaxf(c.x, c.y), fmaxf(c.z, c.w));
      } else {
        int side = m >> lvl;
        int cyc = min(max(icy, 0), side - 1);
        int cxc = min(max(icx, 0), side - 1);
        long long off = ((mm - (mm >> (2 * lvl))) * 4) / 3;
        cmax = __ldg(g.pyr + off + (long long)cyc * side + cxc);
      }

      bool skip = zmin > cmax;
      bool descend = !skip && !at_fine;
      bool hit_now = false;
      float t_c = BIG_T;
      if (!skip && at_fine) {
        if (COUNT) ++w.tests;
        float t_lo = t - T_TOL, t_hi = t_exit_c + T_TOL;
        if (g.kind == TRIANGLE)
          intersect_triangles(ox, oy, oz, dx, dy, dz, icx, icy, c.x, c.y, c.z, c.w, t_lo, t_hi,
                              hit_now, t_c);
        else if (g.kind == BILINEAR)
          intersect_bilinear(ox, oy, oz, dx, dy, dz, icx, icy, c.x, c.y, c.z, c.w, t_lo, t_hi,
                             hit_now, t_c);
        else
          intersect_flat(ox, oy, oz, dx, dy, dz, c.x, c.y, c.z, c.w, t_lo, t_hi, hit_now, t_c);
      }

      if (hit_now) {
        alive = 0;
        h = MarchHit{1, t_c, icx, icy};
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
        int asc = skip ? ascent_levels(e.bnd) : 0;
        asc = min(asc, (levels - 1) - lvl);
        lvl = lvl + asc;
        icx = e.nx >> asc;  // arithmetic shift: nx may be -1
        icy = e.ny >> asc;
        t = fmaxf(t, t_exit_c);
        int new_side = m >> lvl;
        bool escaped = (oz + t * dz > gmax) && (dz > 0.0f);
        bool out = (e.t >= t1 - EPS_EXIT) || icx < 0 || icx >= new_side || icy < 0 ||
                   icy >= new_side || escaped;
        if (out) {
          alive = 0;
        } else if (lvl == 0) {
          // still in the run: the next cell's record is in slot j + 1;
          // slot j takes the cell RING steps ahead
          const CellExit f = cell_exit(r, qx, qy, 1.0f);
          qx = f.nx;
          qy = f.ny;
          q[j] = cell_record(g, qx, qy);
        } else {
          ring = false;
        }
      }
      if (COUNT) ++w.steps;
      ++st;
    }
  }
  s.alive = alive;
  s.t = t;
  s.lvl = lvl;
  s.icx = icx;
  s.icy = icy;
  return st;
}

// The boundary exit of the level-0 DDA k cells along one axis from
// boundary index b0 (step s = +-1): cell_exit's tx (or ty) of that cell, the
// same expression with side 1, and BIG_T on an axis the ray does not cross.
static __device__ __forceinline__ float axis_exit(int b0, int k, int s, float o, float inv,
                                                  bool none) {
  return none ? BIG_T : ((float)(b0 + k * s) * 1.0f - o) * inv;
}

// The cell k steps on from level-0 cell (icx, icy) along the ray's DDA: its
// x-steps among those k are the smallest i in [0, k] whose x exit comes
// after the y exit of step k - 1 - i (not tx <= ty, as cell_exit breaks a
// tie), found by binary search over the two exit sequences.
static __device__ __forceinline__ void dda_cell(const MarchRay& r, int icx, int icy, int k,
                                                int& cx, int& cy) {
  const bool pos_x = r.dx > 0.0f, pos_y = r.dy > 0.0f;
  const int sx = pos_x ? 1 : -1, sy = pos_y ? 1 : -1;
  const bool none_x = fabsf(r.dx) < TINY, none_y = fabsf(r.dy) < TINY;
  const int bx0 = icx + (pos_x ? 1 : 0), by0 = icy + (pos_y ? 1 : 0);
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(axis_exit(bx0, mid, sx, r.ox, r.inv_x, none_x) <=
          axis_exit(by0, k - 1 - mid, sy, r.oy, r.inv_y, none_y)))
      hi = mid;
    else
      lo = mid + 1;
  }
  cx = icx + lo * sx;
  cy = icy + (k - lo) * sy;
}

// The per-ray constants of the tail's tests under the terrain (the torch
// below_margins, in its float order): a ray that over a test window stays
// below a cell's (or a block's) lowest corner `lo` by m0 + (hi - lo) * m1
// cannot be hit there; a descending ray under zfloor has only such cells
// left. m0 covers the window's slack, the rounding at the heights'
// magnitude and the intersectors' divisor floor (safe), m1 the containment
// slack and the rounding at the ray's world magnitude, per unit of corner
// span (PERF.md, "the margin").
// "flat" hits any ray under its column: it takes none of them.
struct Below {
  float m0, m1, zfloor;
};

static __device__ __forceinline__ Below below_margins(const MarchRay& r, int kind, int m,
                                                      float gmin, float gmax) {
  const float at1 = fabsf(r.t1);
  const float a = ((fabsf(r.ox) + fabsf(r.oy)) + at1 * (fabsf(r.dx) + fabsf(r.dy))) +
                  (float)(2 * m + 2);
  const float z = (fabsf(r.oz) + fmaxf(fabsf(gmin), fabsf(gmax))) + at1 * fabsf(r.dz);
  Below b;
  b.m0 = MARGIN_TOL * fabsf(r.dz) + MARGIN_Z * z + MARGIN_SAFE * at1;
  b.m1 = MARGIN_S + MARGIN_A * a;
  if (kind == BILINEAR) {
    b.m0 = b.m0 + MARGIN_LIN * (at1 * at1);
    b.m1 = b.m1 + MARGIN_A2 * (a * a);
  }
  b.zfloor = r.dz < 0.0f ? gmin - (b.m0 + (gmax - gmin) * b.m1) : -BIG_T;
  return b;
}

// How many boundaries of one axis the level-0 DDA crosses before t_cross,
// from boundary index b0 (step s): the smallest k in [0, top] whose exit
// (axis_exit) is not before t_cross, "before" being < against an x crossing
// (the y axis) and <= against a y crossing (a tie steps x first). The exits
// never decrease along an axis, so a binary search finds it.
static __device__ __forceinline__ int dda_steps(int b0, int s, float o, float inv, bool none,
                                                float t_cross, bool strict, int top) {
  int lo = 0, hi = top;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float e = axis_exit(b0, mid, s, o, inv, none);
    if (strict ? e < t_cross : e <= t_cross)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The level-0 cell the DDA from level-0 cell (icx, icy) enters when it
// leaves that cell's level-`lvl` block (bx, by) across exit `e`
// (cell_exit of the block): on the crossed axis the first cell past the
// block; on the other the cell where the steps the DDA takes inside the
// block before the crossing put it (the torch block_crossing).
static __device__ __forceinline__ void block_crossing(const MarchRay& r, const CellExit& e,
                                                      int bx, int by, int lvl, int& icx,
                                                      int& icy) {
  const int side = 1 << lvl;
  const bool pos_x = r.dx > 0.0f, pos_y = r.dy > 0.0f;
  if (e.nx != bx) {
    const int top = pos_y ? by * side + (side - 1) - icy : icy - by * side;
    const int k = dda_steps(icy + (pos_y ? 1 : 0), pos_y ? 1 : -1, r.oy, r.inv_y,
                            fabsf(r.dy) < TINY, e.t, true, top);
    icx = e.nx * side + (pos_x ? 0 : side - 1);
    icy = icy + (pos_y ? k : -k);
  } else {
    const int top = pos_x ? bx * side + (side - 1) - icx : icx - bx * side;
    const int k = dda_steps(icx + (pos_x ? 1 : 0), pos_x ? 1 : -1, r.ox, r.inv_x,
                            fabsf(r.dx) < TINY, e.t, false, top);
    icx = icx + (pos_x ? k : -k);
    icy = e.ny * side + (pos_y ? 0 : side - 1);
  }
}

// Up to `budget` steps of the forced-level-0 tail of one ray, one lane a
// ray, as the torch l0_min_step takes them (see above): s.icx, s.icy is the
// level-0 cell of the walk, s.lvl the level of the block around it that
// the next step takes. `pyr_min` is the flat min pyramid of levels >= 1,
// `gmin` its top. A hit ends the ray and sets `h`. While the ray stays at
// level 0 the records of the next RING cells are in flight, as in
// march_steps. Returns the steps taken; COUNT adds them and the exact cell
// tests to `w`.
template <bool COUNT>
static __device__ __forceinline__ int l0_min_steps(const MarchRay& r, MarchState& s,
                                                   MarchHit& h, int budget, const Terrain& g,
                                                   const float* __restrict__ pyr_min,
                                                   float gmin, float gmax, Work& w) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float t1 = r.t1;
  const int m = g.m, levels = g.levels;
  const long long mm = (long long)m * m;
  const bool below_on = g.kind != FLAT;
  const Below b = below_margins(r, g.kind, m, gmin, gmax);
  int alive = s.alive;
  float t = s.t;
  int lvl = s.lvl, icx = s.icx, icy = s.icy;

  float4 q[RING];      // records of the current level-0 cell and the next ones
  int qx = 0, qy = 0;  // the cell of the last record issued
  bool ring = false;   // q is live: this step's cell is at level 0 and its record is in q
  int st = 0;
  while (st < budget && alive) {
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      if (st >= budget || !alive) break;
      const int bx = icx >> lvl, by = icy >> lvl;
      const CellExit e = cell_exit(r, bx, by, (float)(1 << lvl));
      const float t_exit_c = fminf(e.t, t1);
      const float za = t * dz, zb = t_exit_c * dz;
      const float zmin = oz + fminf(za, zb);

      float lo, hi;  // the cell's or the block's lowest and highest corner
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lvl == 0) {
        if (!ring) {  // entering a level-0 run: issue this cell and the next RING-1
          qx = icx;
          qy = icy;
          q[j] = cell_record(g, qx, qy);
#pragma unroll
          for (int k = 1; k < RING; ++k) {
            const CellExit f = cell_exit(r, qx, qy, 1.0f);
            qx = f.nx;
            qy = f.ny;
            q[(j + k) % RING] = cell_record(g, qx, qy);
          }
          ring = true;
        }
        c = q[j];
        hi = fmaxf(fmaxf(c.x, c.y), fmaxf(c.z, c.w));
        lo = fminf(fminf(c.x, c.y), fminf(c.z, c.w));
      } else {
        const int side = m >> lvl;
        const long long k = ((mm - (mm >> (2 * lvl))) * 4) / 3 +
                            (long long)min(max(by, 0), side - 1) * side + min(max(bx, 0), side - 1);
        hi = __ldg(g.pyr + k);
        lo = __ldg(pyr_min + (k - mm));
      }
      const bool under = below_on && oz + fmaxf(za, zb) + (b.m0 + (hi - lo) * b.m1) < lo;
      bool hit_now = false;
      float t_c = BIG_T;
      if (lvl == 0 && !under && !(zmin > hi)) {
        if (COUNT) ++w.tests;
        intersect_cell(g.kind, r, icx, icy, c, t - T_TOL, t_exit_c + T_TOL, hit_now, t_c);
      }

      if (hit_now) {
        alive = 0;
        h = MarchHit{1, t_c, icx, icy};
      } else if (lvl > 0 && !under) {
        lvl = lvl - 1;  // descend: the same level-0 cell, in the child block
      } else {
        t = fmaxf(t, t_exit_c);
        if (lvl == 0) {
          icx = e.nx;
          icy = e.ny;
        } else {
          block_crossing(r, e, bx, by, lvl, icx, icy);
        }
        if (under) lvl = lvl + min(ascent_levels(e.bnd), (levels - 1) - lvl);
        const float z_new = oz + t * dz;
        const bool out = (e.t >= t1 - EPS_EXIT) || icx < 0 || icx >= m || icy < 0 ||
                         icy >= m || ((z_new > gmax) && (dz > 0.0f)) ||
                         (below_on && z_new < b.zfloor);
        if (out) {
          alive = 0;
        } else if (lvl == 0) {
          // still in the run: the next cell's record is in slot j + 1;
          // slot j takes the cell RING steps ahead
          const CellExit f = cell_exit(r, qx, qy, 1.0f);
          qx = f.nx;
          qy = f.ny;
          q[j] = cell_record(g, qx, qy);
        } else {
          ring = false;
        }
      }
      if (COUNT) ++w.steps;
      ++st;
    }
  }
  s.alive = alive;
  s.t = t;
  s.lvl = lvl;
  s.icx = icx;
  s.icy = icy;
  return st;
}

// Up to `budget` steps of the forced-level-0 tail of one ray, marched by a
// group of G lanes (G a power of two <= 32; `gmask` the group's lanes of the
// warp, `k` this lane's rank in it), which all call it together with the
// same ray and state and leave with the same `s`, `h` and `w`. Each window,
// lane k takes the cell k steps on from the current one (dda_cell); its
// own exit, record, skip, exact and out tests are l0_min_steps' level-0
// expressions, with the t it enters at taken as the prefix max of the
// earlier lanes' exits (the serial t, bit for bit). The first lane that
// ends the ray (a hit, out of the map, up or under the floor, or past the
// budget) gives the ray its state, as the serial march leaves it after
// that cell (the torch l0_min_step with hierarchy=False); with none,
// the ray moves on G cells. A window has G record loads in flight, and the
// next window's are issued before this one is tested (its cells follow
// from the geometry alone), so a window waits on no load of its own unless
// it is the ray's first. Returns the steps taken; COUNT adds them and the
// cell tests up to the end to `w`, as march_steps does.
template <bool COUNT, int G>
static __device__ __forceinline__ int l0_group_steps(const MarchRay& r, MarchState& s,
                                                     MarchHit& h, int budget, const Terrain& g,
                                                     float gmin, float gmax, Work& w, int k,
                                                     unsigned gmask) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float t1 = r.t1;
  const int m = g.m;
  const bool below_on = g.kind != FLAT;
  const float zfloor = below_margins(r, g.kind, m, gmin, gmax).zfloor;
  const int gbase = (int)(threadIdx.x & 31) & ~(G - 1);
  const unsigned gbits = G == 32 ? FULL_WARP : (1u << (G & 31)) - 1u;
  int alive = s.alive;
  float t = s.t;
  int icx = s.icx, icy = s.icy;
  int cx, cy;  // this lane's cell of the window, and its record
  dda_cell(r, icx, icy, k, cx, cy);
  float4 c = cell_record(g, cx, cy);
  int st = 0;
  while (st < budget && alive) {  // uniform over the group
    // the next window's cell: k + G steps on from this window's first
    int ncx, ncy;
    dda_cell(r, icx, icy, k + G, ncx, ncy);
    const float4 nc = cell_record(g, ncx, ncy);
    const CellExit e = cell_exit(r, cx, cy, 1.0f);
    const float t_exit_c = fminf(e.t, t1);
    // inc: the max of the exits of cells 0..k of the window; t after cell k
    // is fmaxf(t, inc), the t this cell is entered at the same over 0..k-1
    float inc = t_exit_c;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const float o = __shfl_up_sync(gmask, inc, d, G);
      if (k >= d) inc = fmaxf(inc, o);
    }
    const float before = __shfl_up_sync(gmask, inc, 1, G);
    const float t_k = k == 0 ? t : fmaxf(t, before);
    const float zmin = oz + fminf(t_k * dz, t_exit_c * dz);
    const float cmax = fmaxf(fmaxf(c.x, c.y), fmaxf(c.z, c.w));
    const bool run = k < budget - st;  // this cell is within the budget
    const bool test = run && !(zmin > cmax);
    bool hit_now = false;
    float t_c = BIG_T;
    if (test) {
      const float t_lo = t_k - T_TOL, t_hi = t_exit_c + T_TOL;
      if (g.kind == TRIANGLE)
        intersect_triangles(ox, oy, oz, dx, dy, dz, cx, cy, c.x, c.y, c.z, c.w, t_lo, t_hi,
                            hit_now, t_c);
      else if (g.kind == BILINEAR)
        intersect_bilinear(ox, oy, oz, dx, dy, dz, cx, cy, c.x, c.y, c.z, c.w, t_lo, t_hi,
                           hit_now, t_c);
      else
        intersect_flat(ox, oy, oz, dx, dy, dz, c.x, c.y, c.z, c.w, t_lo, t_hi, hit_now, t_c);
    }
    const float t_new = fmaxf(t, inc);
    const float z_new = oz + t_new * dz;
    const bool out = (e.t >= t1 - EPS_EXIT) || e.nx < 0 || e.nx >= m || e.ny < 0 ||
                     e.ny >= m || ((z_new > gmax) && (dz > 0.0f)) ||
                     (below_on && z_new < zfloor);
    const unsigned ends = (__ballot_sync(gmask, !run || hit_now || out) >> gbase) & gbits;
    const unsigned tests = (__ballot_sync(gmask, test) >> gbase) & gbits;
    if (ends == 0) {  // no cell of the window ends the ray: on from the last one's exit
      t = __shfl_sync(gmask, t_new, G - 1, G);
      icx = __shfl_sync(gmask, e.nx, G - 1, G);
      icy = __shfl_sync(gmask, e.ny, G - 1, G);
      cx = ncx;
      cy = ncy;
      c = nc;
      if (COUNT) {
        w.steps += G;
        w.tests += __popc(tests);
      }
      st += G;
      continue;
    }
    const int f = __ffs(ends) - 1;
    const bool f_run = __shfl_sync(gmask, run, f, G);
    const bool f_hit = __shfl_sync(gmask, hit_now, f, G);
    const int taken = f + (f_run ? 1 : 0);  // cells stepped: up to f, and f itself if it ran
    if (COUNT) {
      w.steps += taken;
      w.tests += __popc(tests & (taken >= 32 ? FULL_WARP : (1u << taken) - 1u));
    }
    st += taken;
    if (f_run && !f_hit) {  // out: the serial step has advanced to the next cell
      alive = 0;
      t = __shfl_sync(gmask, t_new, f, G);
      icx = __shfl_sync(gmask, e.nx, f, G);
      icy = __shfl_sync(gmask, e.ny, f, G);
    } else {  // a hit in cell f, or the budget spent before it: the ray stands in it
      t = __shfl_sync(gmask, t_k, f, G);
      icx = __shfl_sync(gmask, cx, f, G);
      icy = __shfl_sync(gmask, cy, f, G);
      if (f_hit) {
        alive = 0;
        h = MarchHit{1, __shfl_sync(gmask, t_c, f, G), icx, icy};
      }
    }
  }
  s.alive = alive;
  s.t = t;
  s.icx = icx;
  s.icy = icy;
  return st;
}

// Up to `budget` steps of the relaxed level-0 tail of one ray (the torch
// `l0_step_relaxed`, line for line); `stride` is in cells. A sample below
// the cell surface sends the ray back to the last sample above, to walk the
// bracket cell by cell with the exact test; past the bracket without a hit
// it samples again. The mode and the bracket ride in `s` (rmode, tprev,
// wend). COUNT instances count every step, and the walk's exact tests. A
// simple loop with one record load a step: no prefetch.
template <bool COUNT>
static __device__ __forceinline__ int relaxed_steps(const MarchRay& r, MarchState& s,
                                                    MarchHit& h, int budget, const Terrain& g,
                                                    float gmax, int stride, Work& w) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float t1 = r.t1;
  const int m = g.m;
  const float stride_t = (float)stride * fminf(fabsf(r.inv_x), fabsf(r.inv_y));
  int alive = s.alive, icx = s.icx, icy = s.icy, rmode = s.rmode;
  float t = s.t, tprev = s.tprev, wend = s.wend;
  int st = 0;
  for (; st < budget && alive; ++st) {
    if (rmode != 0 && t > wend + T_TOL) {  // bracket passed: sample from here
      rmode = 0;
      tprev = t;
    }
    const float4 c = cell_record(g, icx, icy);
    if (rmode != 0) {  // the exact walk
      const CellExit e = cell_exit(r, icx, icy, 1.0f);
      const float t_exit_c = fminf(e.t, t1);
      bool hit_now;
      float t_c;
      if (COUNT) ++w.tests;
      intersect_cell(g.kind, r, icx, icy, c, t - T_TOL, t_exit_c + T_TOL, hit_now, t_c);
      if (hit_now) {
        alive = 0;
        h = MarchHit{1, t_c, icx, icy};
      } else {
        t = fmaxf(t, t_exit_c);
        icx = e.nx;
        icy = e.ny;
        bool escaped = (oz + t * dz > gmax) && (dz > 0.0f);
        if ((e.t >= t1 - EPS_EXIT) || icx < 0 || icx >= m || icy < 0 || icy >= m || escaped)
          alive = 0;
      }
    } else {  // a sample at the current position
      float zs = surface_cell(g.kind, ox + t * dx - (float)icx, oy + t * dy - (float)icy, c);
      if (oz + t * dz <= zs) {  // below: walk from the last sample above
        wend = t;
        t = tprev;
        icx = floor_cell(ox + tprev * dx, m);
        icy = floor_cell(oy + tprev * dy, m);
        rmode = 1;
      } else {
        float ts_new = fmaxf(t, fminf(t + stride_t, t1 - EPS_EXIT));
        bool sout = t >= t1 - 2.0f * EPS_EXIT;
        bool sesc = (oz + ts_new * dz > gmax) && (dz > 0.0f);
        if (sout || sesc) {
          alive = 0;
        } else {
          tprev = t;
          t = ts_new;
          icx = floor_cell(ox + ts_new * dx, m);
          icy = floor_cell(oy + ts_new * dy, m);
        }
      }
    }
    if (COUNT) ++w.steps;
  }
  s.alive = alive;
  s.t = t;
  s.icx = icx;
  s.icy = icy;
  s.rmode = rmode;
  s.tprev = tprev;
  s.wend = wend;
  return st;
}

// ---- the warp-level work queue of the persistent kernels ----------------
//
// Each warp loops: its idle lanes claim the next items of a stream of
// `total` work items from a device counter (one atomicAdd by the first idle
// lane for all of them; each takes base + its rank among the idle lanes),
// every lane holding an item marches it a chunk of steps, and a lane whose
// item is finished writes it back and goes idle. A warp claims only when at
// least `min_idle` lanes are idle, and once the counter has passed `total`
// (`more` false, warp-uniform) it claims no more. Every lane of the warp
// must call it together. Claims are consecutive runs of the stream, so a
// warp's items are neighbours (sorted rays, or the pixels of a patch).
static __device__ __forceinline__ int claim_item(int* next, int total, bool idle, int min_idle,
                                                 bool& more) {
  const unsigned mask = __ballot_sync(FULL_WARP, idle);
  const int n_idle = __popc(mask);
  if (!more || n_idle < min_idle) return -1;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(next, n_idle);
  base = __shfl_sync(FULL_WARP, base, leader);
  more = base + n_idle < total;
  const int k = base + __popc(mask & ((1u << lane) - 1u));
  return idle && k < total ? k : -1;
}

// Blocks of a persistent launch: as many as fit on the card at once (one
// resident wave), and no more than the items need.
template <typename Kernel>
static int persistent_blocks(Kernel kernel, int threads, long long items) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  long long want = (items + threads - 1) / threads;
  long long wave = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  return (int)(want < wave ? want : wave);
}
