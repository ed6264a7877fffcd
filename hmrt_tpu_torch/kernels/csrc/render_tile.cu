// The fused render: one thread per pixel does the whole frame's work.
//
// Replaces the TPU kernel hmrt_tpu/kernels/raycast.py::_render_kernel
// (launched by raycast.py::_render_pallas_jit). Per pixel: the primary ray
// from the camera params vector, clipped to the terrain box (or the clip
// window), the sky early-out, the unbudgeted max-mip march from the pyramid
// top, the normal and albedo at the hit, a shadow ray toward the sun that
// starts at level 0 in the hit cell, Lambert or Phong, fog, sky, and the
// clip to [0, 1]. It writes the colour into the Frame's (H, W, 3) layout,
// the hit flag into (H, W), and on request the depth, the normals and the
// hit cells. `row0` and `full_h` place the render as a band of rows of a
// taller screen (rendering under sharding).
//
// What it computes is what the TPU kernel computes; its Mosaic schedule is
// not carried over. The coarse VMEM buffer, the column-cascade demand loop
// with its DMA and semaphores, n_col, the ascent cap and the tile height
// existed because the TPU has no gather; they only decide which rays step
// when, so they cannot change a hit. Here the pyramid, the heights and the
// gradient planes are read with plain global loads (march_common.cuh,
// shade_common.cuh: the same code as the march and shade passes).
//
// What bounds it on the H100: like the march pass, dependent global loads
// and divergence, not bytes or operations. Each thread walks a chain of
// dependent loads (cell max -> skip test -> next cell) for its primary ray
// and again for its shadow ray, and a warp lasts as long as its longest
// ray; there is no sort between passes to regroup the long rays. What this
// first design does about it: only coherent warps. A block of 256 threads
// covers a 32 x 8 pixel tile and each warp an 8 x 4 patch, so the rays of
// a warp start close together and march through nearby terrain.
//
// Exactness: the ray directions equal Camera.rays bit for bit (the same
// expressions in the same order; 1/W and 1/full_h are the f32 reciprocals
// raygen multiplies by; normalised by a division), and the march, the
// shade data and the colour maths follow the torch plain version in order.
// The build's -fmad=false -prec-div=true -prec-sqrt=true keep those bits.

#include <cuda_runtime.h>

#include "march_common.cuh"
#include "shade_common.cuh"

namespace {

// params vector layout: hmrt_tpu/kernels/raycast.py _P_* (f32[32])
constexpr int P_EYE = 0, P_RIGHT = 3, P_UP = 6, P_FWD = 9, P_TANHALF = 12, P_ASPECT = 13,
              P_SUN = 14, P_SUNCOL = 17, P_SKYTOP = 20, P_SKYHOR = 23, P_FOGCOL = 26,
              P_GMAX = 29, P_ROW0 = 30;
constexpr float SHADOW_EPS = 1e-2f;  // core/renderer.py SHADOW_EPS

// a block of 256 threads covers a 32 x 8 pixel tile: its 8 warps are laid
// out 4 across and 2 down, each on an 8 x 4 patch
constexpr int TILE_X = 32, TILE_Y = 8, THREADS = TILE_X * TILE_Y;

struct TileArgs {
  const float* params;
  const float* pyr;
  const float* heights;
  const float* gx;
  const float* gy;
  const float* albedo;  // planar (3, N*N), or null: untextured
  float* color;         // (H, W, 3)
  int* hit;             // (H, W)
  float* depth;         // (H, W) or null
  float* normal;        // (H, W, 3) or null
  int* cell;            // (H, W, 2) hit cell (hx, hy), or null
  int H, W, full_h, n, m, levels, kind;
  int phong, shadows, fog;
  float ambient, specular, shininess, fog_density, box_lo, box_hi;
};

__global__ void __launch_bounds__(THREADS) render_tile_kernel(TileArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * TILE_X + (warp & 3) * 8 + (lane & 7);
  const int i = blockIdx.y * TILE_Y + (warp >> 2) * 4 + (lane >> 3);
  if (i >= a.H || j >= a.W) return;
  const float* P = a.params;

  // ---- raygen: Camera.rays' expressions (types.py) ----
  const float inv_w = 1.0f / (float)a.W;
  const float inv_fh = 1.0f / (float)a.full_h;
  float ndc_x = ((float)j + 0.5f) * inv_w * 2.0f - 1.0f;
  float ndc_y = 1.0f - (((float)i + P[P_ROW0]) + 0.5f) * inv_fh * 2.0f;
  float sx = ndc_x * P[P_TANHALF] * P[P_ASPECT];
  float sy = ndc_y * P[P_TANHALF];
  float dx = P[P_FWD + 0] + sx * P[P_RIGHT + 0] + sy * P[P_UP + 0];
  float dy = P[P_FWD + 1] + sx * P[P_RIGHT + 1] + sy * P[P_UP + 1];
  float dz = P[P_FWD + 2] + sx * P[P_RIGHT + 2] + sy * P[P_UP + 2];
  float nrm = sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx / nrm;
  dy = dy / nrm;
  dz = dz / nrm;
  const float ox = P[P_EYE + 0], oy = P[P_EYE + 1], oz = P[P_EYE + 2];
  const float gmax = P[P_GMAX];
  const Terrain g{a.pyr, a.heights, a.n, a.m, a.levels, a.kind, gmax};

  // ---- primary march from the pyramid top, with the sky early-out ----
  MarchRay r{ox, oy, oz, dx, dy, dz, 1.0f / safe(dx), 1.0f / safe(dy), 0.0f};
  float t0;
  ray_box(ox, oy, r.inv_x, r.inv_y, a.box_lo, a.box_hi, t0, r.t1);
  bool valid = (r.t1 > t0) && !((oz + t0 * dz > gmax) && (dz >= 0.0f));
  // the top level has one cell: the entry cell is (0, 0)
  MarchState s{valid ? 1 : 0, valid ? t0 : BIG_T, a.levels - 1, 0, 0, 0, BIG_T, 0, 0};
  march_steps(r, s, UNBUDGETED, g);
  const bool hit = s.hit != 0;

  // ---- shade data at the hit point ----
  float ts = hit ? s.t_hit : 0.0f;
  float px = ox + ts * dx;
  float py = oy + ts * dy;
  float pz = oz + ts * dz;
  float fx = fminf(fmaxf(px - (float)s.hx, 0.0f), 1.0f);
  float fy = fminf(fmaxf(py - (float)s.hy, 0.0f), 1.0f);
  ShadeData d = shade_lane(hit, s.hx, s.hy, fx, fy, a.gx, a.gy, a.albedo, a.n);

  const float lx = P[P_SUN + 0], ly = P[P_SUN + 1], lz = P[P_SUN + 2];
  float diff = fmaxf(d.nx * lx + d.ny * ly + d.nz * lz, 0.0f);

  // ---- shadow ray from just above the hit, at level 0 in the hit cell ----
  bool occ = false;
  if (a.shadows && hit) {
    float sxo = px + lx * SHADOW_EPS + d.nx * SHADOW_EPS;
    float syo = py + ly * SHADOW_EPS + d.ny * SHADOW_EPS;
    float szo = pz + lz * SHADOW_EPS + d.nz * SHADOW_EPS;
    MarchRay sr{sxo, syo, szo, lx, ly, lz, 1.0f / safe(lx), 1.0f / safe(ly), 0.0f};
    float st0;
    ray_box(sxo, syo, sr.inv_x, sr.inv_y, a.box_lo, a.box_hi, st0, sr.t1);
    bool sv = (sr.t1 > st0) && !((szo + st0 * lz > gmax) && (lz >= 0.0f));
    MarchState ss{sv ? 1 : 0, sv ? st0 : BIG_T, 0, min(max(s.hx, 0), a.m - 1),
                  min(max(s.hy, 0), a.m - 1), 0, BIG_T, 0, 0};
    march_steps(sr, ss, UNBUDGETED, g);
    occ = ss.hit != 0;
    if (occ) diff = 0.0f;
  }

  // ---- colour ----
  const float sr_ = P[P_SUNCOL + 0], sg_ = P[P_SUNCOL + 1], sb_ = P[P_SUNCOL + 2];
  float cr = d.ar * (a.ambient + diff * sr_);
  float cg = d.ag * (a.ambient + diff * sg_);
  float cb = d.ab * (a.ambient + diff * sb_);
  if (a.phong) {
    // phong_specular with V = -d
    float ndl = d.nx * lx + d.ny * ly + d.nz * lz;
    float rx = 2.0f * ndl * d.nx - lx;
    float ry = 2.0f * ndl * d.ny - ly;
    float rz = 2.0f * ndl * d.nz - lz;
    float rdv = fmaxf(rx * -dx + ry * -dy + rz * -dz, 0.0f);
    float spec = ndl > 0.0f ? powf(rdv, a.shininess) : 0.0f;
    if (occ) spec = 0.0f;
    cr = cr + a.specular * spec * sr_;
    cg = cg + a.specular * spec * sg_;
    cb = cb + a.specular * spec * sb_;
  }
  if (a.fog) {
    float f = expf(-ts * a.fog_density);
    cr = cr * f + P[P_FOGCOL + 0] * (1 - f);
    cg = cg * f + P[P_FOGCOL + 1] * (1 - f);
    cb = cb * f + P[P_FOGCOL + 2] * (1 - f);
  }
  if (!hit) {
    float u = sqrtf(fminf(fmaxf(dz, 0.0f), 1.0f));
    cr = P[P_SKYHOR + 0] * (1.0f - u) + P[P_SKYTOP + 0] * u;
    cg = P[P_SKYHOR + 1] * (1.0f - u) + P[P_SKYTOP + 1] * u;
    cb = P[P_SKYHOR + 2] * (1.0f - u) + P[P_SKYTOP + 2] * u;
  }

  const long long px_i = (long long)i * a.W + j;
  a.color[px_i * 3 + 0] = fminf(fmaxf(cr, 0.0f), 1.0f);
  a.color[px_i * 3 + 1] = fminf(fmaxf(cg, 0.0f), 1.0f);
  a.color[px_i * 3 + 2] = fminf(fmaxf(cb, 0.0f), 1.0f);
  a.hit[px_i] = hit ? 1 : 0;
  if (a.depth != nullptr) a.depth[px_i] = hit ? s.t_hit : __int_as_float(0x7f800000);  // +inf
  if (a.normal != nullptr) {
    a.normal[px_i * 3 + 0] = hit ? d.nx : 0.0f;
    a.normal[px_i * 3 + 1] = hit ? d.ny : 0.0f;
    a.normal[px_i * 3 + 2] = hit ? d.nz : 0.0f;
  }
  if (a.cell != nullptr) {
    a.cell[px_i * 2 + 0] = s.hx;
    a.cell[px_i * 2 + 1] = s.hy;
  }
}

}  // namespace

extern "C" int hmrt_render_tile(const float* params, const float* pyr, const float* heights,
                                const float* gx, const float* gy, const float* albedo,
                                float* color, int* hit, float* depth, float* normal, int* cell,
                                int H, int W, int full_h, int n, int m, int levels,
                                int intersector, int phong, int shadows, int fog, float ambient,
                                float specular, float shininess, float fog_density,
                                float box_lo, float box_hi, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  TileArgs a{params, pyr,    heights, gx, gy,   albedo, color,  hit,     depth,
             normal, cell,   H,       W,  full_h, n,    m,      levels,  intersector,
             phong,  shadows, fog,    ambient, specular, shininess, fog_density, box_lo,
             box_hi};
  dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y);
  render_tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
