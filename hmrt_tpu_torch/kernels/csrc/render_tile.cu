// The fused render: every pixel's whole work in one kernel.
//
// Replaces the TPU kernel hmrt_tpu/kernels/raycast.py::_render_kernel
// (launched by raycast.py::_render_pallas_jit). Per pixel: the primary ray
// from the camera params vector, clipped to the terrain box (or the clip
// window), the sky early-out, the unbudgeted march from the pyramid top (the
// max-mip march above the terrain, the min walk under it:
// march_common.cuh fused_steps), the normal and albedo at the hit, a shadow
// ray toward the sun that starts at level 0 in the hit cell, marched the
// same way, Lambert or Phong, fog, sky, and the clip to [0, 1]. It writes
// the colour into the Frame's (H, W, 3) layout,
// the hit flag into (H, W), and on request the depth, the normals and the
// hit cells. `row0` and `full_h` place the render as a band of rows of a
// taller screen (rendering under sharding).
//
// What it computes is what the TPU kernel computes; its Mosaic schedule is
// not carried over. The coarse VMEM buffer, the column-cascade demand loop
// with its DMA and semaphores, n_col, the ascent cap and the tile height
// existed because the TPU has no gather; they only decide which rays step
// when, so they cannot change a hit. Here the pyramid, the level-0 corner
// records and the gradient planes are read with plain loads
// (march_common.cuh, shade_common.cuh: the same code as the march and shade
// passes).
//
// What bounds it on the H100: like the march pass, the steps themselves,
// not bytes, and the warps the registers leave room for; an 8 x 4 patch
// keeps 98% of its lanes busy even with the primary and the shadow march
// run one after the other (PERF.md). What this design does:
//   - the level-0 corner records, prefetched along the ray (march_common.cuh);
//   - persistent warps over a patch-major pixel stream: the pixels are
//     numbered by 8 x 4 patches in row-major order of patches, the 32 pixels
//     of a patch consecutive. One resident wave of warps claims runs of that
//     stream from a device counter as the march pass claims rays: a fresh
//     warp takes a whole patch, so its rays start together and march
//     through nearby terrain (a partial refill would take the next pixels,
//     in the neighbouring patch);
//   - primary and shadow rays in one step loop: each lane is idle, on its
//     primary ray or on its shadow ray, and all lanes holding a ray march
//     the same CHUNK of steps, so a lane on its shadow ray does not wait for
//     a neighbour's primary ray or the other way round. A finished primary
//     ray computes its shade data and either turns into its shadow ray or
//     writes its pixel; a finished shadow ray writes its pixel; the lane is
//     then refilled;
//   - few registers: the pixel's primary result waits in shared memory
//     during its shadow march, and the direction and shade data are
//     computed again when the pixel is written;
//   - no cell-by-cell walk under the terrain. A ray that enters the map's
//     wall below the surface met no hit in the max-mip march until it left
//     the map, and walked it cell by cell with an exact test each (B3:
//     2,219,896,681 primary steps). fused_steps passes it under whole
//     blocks of the min pyramid and ends it under the map's lowest height,
//     as the level-0 tail of the march pass does (B3: 33,870,132 steps,
//     24.0-24.5 ms -> 0.854-0.861; B1 0.378-0.381 -> 0.096-0.097). One step
//     body serves both modes, so a warp whose lanes differ in mode issues
//     one loop; a loop for each mode (march_steps and l0_min_steps, each
//     stopping where the other mode takes the next step) was 2% faster on
//     B3 and 42% slower on B1 (PERF.md, kernel_times.py). The step body
//     takes 95 registers (80 before), no spill.
// The constants are those of the march pass, measured on the B3 frame
// (kernel_times.py, PERF.md): refilling before the whole warp is idle was
// slower here too.
//
// Exactness: the ray directions equal Camera.rays bit for bit (the same
// expressions in the same order; 1/W and 1/full_h are the f32 reciprocals
// raygen multiplies by; normalised by a division), and the march, the
// shade data and the colour maths (shade_common.cuh shade_color, which the
// compact path's colour pass runs too) follow the torch plain version in
// order.
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

constexpr int THREADS = 64;
// a patch: 8 x 4 pixels, one warp's worth
constexpr int PATCH_X = 8, PATCH_Y = 4;
// steps a lane marches between two looks at the queue
constexpr int CHUNK = 256;
// idle lanes of a warp that make it claim new pixels
constexpr int REFILL_MIN = 32;
// blocks an SM must hold at once: caps the registers a thread may use
// (1: no cap; a cap that buys more warps made ptxas spill)
constexpr int MIN_BLOCKS = 1;

enum Phase { IDLE = 0, PRIMARY = 1, SHADOW = 2 };

struct TileArgs {
  const float* params;
  const float* gx;
  const float* gy;
  const float* albedo;  // planar (3, N*N), or null: untextured
  float* color;         // (H, W, 3)
  int* hit;             // (H, W)
  float* depth;         // (H, W) or null
  float* normal;        // (H, W, 3) or null
  int* cell;            // (H, W, 2) hit cell (hx, hy), or null
  int* counts;          // (4, H, W) primary steps, tests, shadow steps, tests (COUNT only)
  int H, W, full_h, n;
  int phong, shadows, fog;
  float ambient, specular, shininess, fog_density, box_lo, box_hi;
};

// What a lane keeps of its pixel across the shadow march: the primary
// result, in shared memory (it is touched only when the lane changes phase).
// The primary direction and the shade data are computed again from it when
// the pixel is written (the same expressions, so the same bits). Both keep
// registers free for the march, and so more warps on each SM.
struct Pixel {
  int idx;      // i * W + j
  float t_hit;  // the primary result
  int hit, hx, hy;
};

struct Dir {
  float x, y, z;
};

// raygen: Camera.rays' expressions (types.py) for pixel (i, j)
__device__ __forceinline__ Dir pixel_dir(const TileArgs& a, const float* P, int i, int j) {
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
  return Dir{dx / nrm, dy / nrm, dz / nrm};
}

// The primary hit point (the eye on a miss) and the normal and albedo there.
struct HitShade {
  float px, py, pz;
  ShadeData d;
};

__device__ __forceinline__ HitShade shade_hit(const TileArgs& a, const float* P, const Dir& dir,
                                              const Pixel& px) {
  const bool hit = px.hit != 0;
  float ts = hit ? px.t_hit : 0.0f;
  HitShade h;
  h.px = P[P_EYE + 0] + ts * dir.x;
  h.py = P[P_EYE + 1] + ts * dir.y;
  h.pz = P[P_EYE + 2] + ts * dir.z;
  float fx = fminf(fmaxf(h.px - (float)px.hx, 0.0f), 1.0f);
  float fy = fminf(fmaxf(h.py - (float)px.hy, 0.0f), 1.0f);
  h.d = shade_lane(hit, px.hx, px.hy, fx, fy, a.gx, a.gy, a.albedo, a.n);
  return h;
}

// Colour of a pixel whose marches are done, and its outputs.
__device__ __forceinline__ void write_pixel(const TileArgs& a, const float* P, const Pixel& px,
                                            bool occ) {
  const int i = px.idx / a.W;
  const Dir dir = pixel_dir(a, P, i, px.idx - i * a.W);
  const ShadeData d = shade_hit(a, P, dir, px).d;
  const bool hit = px.hit != 0;
  const LightVecs light{P + P_SUN, P + P_SUNCOL, P + P_SKYTOP, P + P_SKYHOR, P + P_FOGCOL};
  const ColorSettings look{a.phong, a.fog, a.ambient, a.specular, a.shininess, a.fog_density};
  const PixelColor c = shade_color(d, dir.x, dir.y, dir.z, hit, px.t_hit, occ, light, look);

  const long long px_i = px.idx;
  a.color[px_i * 3 + 0] = c.r;
  a.color[px_i * 3 + 1] = c.g;
  a.color[px_i * 3 + 2] = c.b;
  a.hit[px_i] = hit ? 1 : 0;
  if (a.depth != nullptr) a.depth[px_i] = c.depth;
  if (a.normal != nullptr) {
    a.normal[px_i * 3 + 0] = c.nx;
    a.normal[px_i * 3 + 1] = c.ny;
    a.normal[px_i * 3 + 2] = c.nz;
  }
  if (a.cell != nullptr) {
    a.cell[px_i * 2 + 0] = px.hx;
    a.cell[px_i * 2 + 1] = px.hy;
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    render_tile_kernel(const TileArgs a, const Terrain g, const float* __restrict__ pyr_min,
                       int* next) {
  __shared__ Pixel lane_pixel[THREADS];
  Pixel& px = lane_pixel[threadIdx.x];
  const float* P = a.params;
  const float gmax = P[P_GMAX];
  // the map's lowest height, the min pyramid's top (its one entry when m = 1)
  const long long min_top = max(pyramid_top(g.m) - (long long)g.m * g.m, 0ll);
  const float gmin = pyr_min != nullptr ? __ldg(pyr_min + min_top) : 0.0f;
  const int patches_x = (a.W + PATCH_X - 1) / PATCH_X;
  const int total = patches_x * ((a.H + PATCH_Y - 1) / PATCH_Y) * 32;
  const long long plane = (long long)a.H * a.W;

  int phase = IDLE;
  int used = 0;      // steps of the lane's current ray
  bool more = true;  // the counter still hands out pixels (warp-uniform)
  MarchRay r{};
  MarchState s{};
  Work w{0, 0};
  for (;;) {
    const int k = claim_item(next, total, phase == IDLE, REFILL_MIN, more);
    if (k >= 0) {
      const int patch = k >> 5, within = k & 31;
      const int j = (patch % patches_x) * PATCH_X + (within & (PATCH_X - 1));
      const int i = (patch / patches_x) * PATCH_Y + (within >> 3);
      if (i < a.H && j < a.W) {
        // ---- the primary ray from the pyramid top, with the sky early-out ----
        const Dir d = pixel_dir(a, P, i, j);
        r = MarchRay{P[P_EYE + 0], P[P_EYE + 1], P[P_EYE + 2], d.x, d.y, d.z,
                     1.0f / safe(d.x), 1.0f / safe(d.y), 0.0f};
        float t0;
        ray_box(r.ox, r.oy, r.inv_x, r.inv_y, a.box_lo, a.box_hi, t0, r.t1);
        bool valid = (r.t1 > t0) && !((r.oz + t0 * d.z > gmax) && (d.z >= 0.0f));
        // the top level has one cell: the entry cell is (0, 0)
        s = MarchState{valid ? 1 : 0, valid ? t0 : BIG_T, g.levels - 1, 0, 0};
        px.idx = i * a.W + j;
        phase = PRIMARY;
        used = 0;
        w = Work{0, 0};
      }
    }
    // a warp with no ray and no pixel left to claim is done; one whose
    // claim fell on the ragged edge only claims again
    if (!__any_sync(FULL_WARP, phase != IDLE)) {
      if (!more) break;
      continue;
    }

    // a hit ends its ray, so it is used in the chunk that finds it
    MarchHit h{0, BIG_T, 0, 0};
    if (phase != IDLE)
      used += fused_steps<COUNT>(r, s, h, min(CHUNK, UNBUDGETED - used), g, pyr_min, gmin,
                                 gmax, w);
    const bool ended = phase != IDLE && (!s.alive || used >= UNBUDGETED);

    if (ended && phase == SHADOW) {
      if (COUNT) {
        a.counts[2 * plane + px.idx] = w.steps;
        a.counts[3 * plane + px.idx] = w.tests;
      }
      write_pixel(a, P, px, h.hit != 0);
      phase = IDLE;
    } else if (ended && phase == PRIMARY) {
      px.t_hit = h.t_hit;
      px.hit = h.hit;
      px.hx = h.hx;
      px.hy = h.hy;
      if (COUNT) {
        a.counts[px.idx] = w.steps;
        a.counts[plane + px.idx] = w.tests;
        a.counts[2 * plane + px.idx] = 0;
        a.counts[3 * plane + px.idx] = 0;
      }
      bool shadow = false;
      if (a.shadows && h.hit) {
        // ---- the shadow ray from just above the hit, at level 0 in the hit cell ----
        const HitShade hs = shade_hit(a, P, Dir{r.dx, r.dy, r.dz}, px);
        const float lx = P[P_SUN + 0], ly = P[P_SUN + 1], lz = P[P_SUN + 2];
        float sxo = hs.px + lx * SHADOW_EPS + hs.d.nx * SHADOW_EPS;
        float syo = hs.py + ly * SHADOW_EPS + hs.d.ny * SHADOW_EPS;
        float szo = hs.pz + lz * SHADOW_EPS + hs.d.nz * SHADOW_EPS;
        r = MarchRay{sxo, syo, szo, lx, ly, lz, 1.0f / safe(lx), 1.0f / safe(ly), 0.0f};
        float st0;
        ray_box(sxo, syo, r.inv_x, r.inv_y, a.box_lo, a.box_hi, st0, r.t1);
        // a shadow ray that starts outside the box or above the terrain
        // occludes nothing and is not marched
        shadow = (r.t1 > st0) && !((szo + st0 * lz > gmax) && (lz >= 0.0f));
        s = MarchState{1, st0, 0, min(max(h.hx, 0), g.m - 1), min(max(h.hy, 0), g.m - 1)};
      }
      if (shadow) {
        phase = SHADOW;
        used = 0;
        w = Work{0, 0};
      } else {
        write_pixel(a, P, px, false);
        phase = IDLE;
      }
    }
  }
}

template <bool COUNT>
int launch(const TileArgs& a, const Terrain& g, const float* pyr_min, int* next,
           cudaStream_t stream) {
  const long long items = (long long)((a.W + PATCH_X - 1) / PATCH_X) *
                          ((a.H + PATCH_Y - 1) / PATCH_Y) * 32;
  const int blocks = persistent_blocks(render_tile_kernel<COUNT>, THREADS, items);
  render_tile_kernel<COUNT><<<blocks, THREADS, 0, stream>>>(a, g, pyr_min, next);
  return (int)cudaGetLastError();
}

}  // namespace

// `pyr_min` is the flat min pyramid of levels >= 1, or null for the witness
// march (the max-mip march alone, which passes under nothing: raycast.py
// fused_witness_planes); `next` is a zeroed int32 on the device (the pixel
// counter); `counts` is null or an int32 (4, H, W) plane that takes each
// pixel's primary steps, primary cell tests, shadow steps and shadow cell
// tests.
extern "C" int hmrt_render_tile(const float* params, const float* pyr, const float* corners,
                                const float* pyr_min, const float* gx, const float* gy,
                                const float* albedo, float* color, int* hit, float* depth,
                                float* normal, int* cell,
                                int H, int W, int full_h, int n, int m, int levels,
                                int intersector, int phong, int shadows, int fog, float ambient,
                                float specular, float shininess, float fog_density,
                                float box_lo, float box_hi, int* next, int* counts,
                                void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  TileArgs a{params,  gx,     gy,      albedo,   color,     hit,         depth,  normal,
             cell,    counts, H,       W,        full_h,    n,           phong,  shadows,
             fog,     ambient, specular, shininess, fog_density, box_lo, box_hi};
  Terrain g{pyr, reinterpret_cast<const float4*>(corners), m, levels, intersector};
  cudaStream_t st = (cudaStream_t)stream;
  return counts != nullptr ? launch<true>(a, g, pyr_min, next, st)
                           : launch<false>(a, g, pyr_min, next, st);
}
