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
// Exactness: the float expressions below are those of the torch and JAX
// march, in the same order. The build uses -fmad=false, -prec-div=true and
// -prec-sqrt=true, because a contracted multiply-add or an approximate
// division moves a grazing hit by an ulp and flips it.

#include <cuda_runtime.h>

namespace {

constexpr float BIG_T = 3.0e38f;
constexpr float EPS_EXIT = 1.0e-6f;
constexpr float T_TOL = 1.0e-3f;
constexpr float TINY = 1.0e-20f;
// containment slack of the intersectors, formed in double as the Python
// expressions `1.0 + eps` and `1.0 - eps` are, then rounded once
constexpr float EPS_IN = 1.0e-6f;
constexpr float ONE_PLUS_EPS = (float)(1.0 + 1.0e-6);
constexpr float ONE_MINUS_EPS = (float)(1.0 - 1.0e-6);

enum Intersector { TRIANGLE = 0, BILINEAR = 1, FLAT = 2 };

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

__device__ __forceinline__ float safe(float x) { return fabsf(x) < TINY ? TINY : x; }

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ void intersect_triangles(float ox, float oy, float oz, float dx, float dy,
                                    float dz, int cx, int cy, float z00, float z10,
                                    float z01, float z11, float t_lo, float t_hi,
                                    bool& hit, float& t) {
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

__device__ void intersect_bilinear(float ox, float oy, float oz, float dx, float dy,
                                   float dz, int cx, int cy, float z00, float z10,
                                   float z01, float z11, float t_lo, float t_hi,
                                   bool& hit, float& t) {
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

__device__ void intersect_flat(float ox, float oy, float oz, float dx, float dy,
                               float dz, float z00, float z10, float z01, float z11,
                               float t_lo, float t_hi, bool& hit, float& t) {
  float zmax = fmaxf(fmaxf(z00, z10), fmaxf(z01, z11));
  bool wall = oz + t_lo * dz <= zmax;
  float t_top = (zmax - oz) / safe(dz);
  bool top = (dz < 0.0f) && (t_top >= t_lo) && (t_top <= t_hi);
  hit = wall || top;
  t = wall ? t_lo : t_top;
}

__device__ __forceinline__ int ascent_levels(int b) {
  return ((b & 1) == 0) + ((b & 3) == 0) + ((b & 7) == 0);
}

__global__ void march_pass_kernel(Planes a, int p, int n, int m, int levels, int budget,
                                  int kind, float box_lo, float box_hi) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;

  int alive = a.alive[i];
  float t = a.t[i];
  int lvl = a.lvl[i], icx = a.icx[i], icy = a.icy[i];
  int hit = a.hit[i];
  float t_hit = a.t_hit[i];
  int hx = a.hx[i], hy = a.hy[i];

  if (alive) {
    float ox = a.ox[i], oy = a.oy[i], oz = a.oz[i];
    float dx = a.dx[i], dy = a.dy[i], dz = a.dz[i];
    // ray_inverses / ray_box_range (only the exit t1 is needed here)
    float inv_x = 1.0f / safe(dx);
    float inv_y = 1.0f / safe(dy);
    float tx0 = (box_lo - ox) * inv_x, tx1 = (box_hi - ox) * inv_x;
    float ty0 = (box_lo - oy) * inv_y, ty1 = (box_hi - oy) * inv_y;
    float t1 = fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1));

    long long mm = (long long)m * m;
    float gmax = a.pyr[(mm * 4 - 1) / 3 - 1];  // the pyramid top

    for (int s = 0; s < budget && alive; ++s) {
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
      float cmax = a.pyr[off + (long long)cyc * side + cxc];

      bool skip = zmin > cmax;
      bool at_fine = lvl == 0;
      bool descend = !skip && !at_fine;
      bool hit_now = false;
      float t_c = BIG_T;
      if (!skip && at_fine) {
        int cx = min(max(icx, 0), n - 2);
        int cy = min(max(icy, 0), n - 2);
        long long base = (long long)cy * n + cx;
        float z00 = a.heights[base], z10 = a.heights[base + 1];
        float z01 = a.heights[base + n], z11 = a.heights[base + n + 1];
        float t_lo = t - T_TOL, t_hi = t_exit_c + T_TOL;
        if (kind == TRIANGLE)
          intersect_triangles(ox, oy, oz, dx, dy, dz, icx, icy, z00, z10, z01, z11, t_lo,
                              t_hi, hit_now, t_c);
        else if (kind == BILINEAR)
          intersect_bilinear(ox, oy, oz, dx, dy, dz, icx, icy, z00, z10, z01, z11, t_lo,
                             t_hi, hit_now, t_c);
        else
          intersect_flat(ox, oy, oz, dx, dy, dz, z00, z10, z01, z11, t_lo, t_hi, hit_now,
                         t_c);
      }

      if (hit_now) {
        alive = 0;
        hit = 1;
        t_hit = t_c;
        hx = icx;
        hy = icy;
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
        bool escaped = (oz + t * dz > gmax) && (dz > 0.0f);
        bool out = (t_exit >= t1 - EPS_EXIT) || icx < 0 || icx >= new_side || icy < 0 ||
                   icy >= new_side || escaped;
        if (out) alive = 0;
      }
    }
  }

  a.alive_o[i] = alive;
  a.t_o[i] = t;
  a.lvl_o[i] = lvl;
  a.icx_o[i] = icx;
  a.icy_o[i] = icy;
  a.hit_o[i] = hit;
  a.t_hit_o[i] = t_hit;
  a.hx_o[i] = hx;
  a.hy_o[i] = hy;
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
