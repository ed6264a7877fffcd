// The colour of every lane of a compact frame, after the shade pass and the
// shadow march.
//
// The JAX package runs these maths as XLA elementwise ops
// (hmrt_tpu/core/renderer.py shade_hits); the plain torch version is
// kernels/shade_color.py::shade_color_reference. Per lane: Lambert, the
// shadow ray's occlusion, Phong, fog, the sky on a miss and the clip to
// [0, 1] (shade_common.cuh shade_color, which the fused tile kernel runs
// too), written in the Frame's layout: the colour (P, 3) interleaved and,
// on request, the depth and the (P, 3) normals.
//
// What bounds it on the H100: the bytes of its planes, each read once and
// written once (chip_smoke.py::hold_shade_color gives the bound beside its
// time: 64% of it on B3's frame, 78% on B4's, PERF.md). In torch the same
// maths was 84 launches on B3's frame (96 on B4's, with fog and texture)
// over the P lanes, each reading and writing whole planes: 0.53 ms on B3's
// frame against the kernel's 0.029.
//
// What this design does about it: one thread a lane, each plane read with
// one coalesced load. A miss reads its hit flag and dz only (its colour is
// the sky); a hit reads its normal and albedo, and its direction, t and
// shadow flag only where the config needs them (Phong, fog or depth,
// shadows). The light's vectors are read by pointer, so the launch takes no
// host copy and a CUDA graph captures it as it captures the shade pass.
//
// Exactness: the arithmetic of the plain version in its order; the build's
// -fmad=false -prec-div=true -prec-sqrt=true keep it bit for bit.

#include <cuda_runtime.h>

#include "shade_common.cuh"

namespace {

constexpr int COLOR_THREADS = 256;  // threads per block, one lane each

struct ColorArgs {
  const int* hit;           // (P,) the primary march's hit flag
  const float* t_hit;       // (P,)
  const float* dx;          // (P,) the primary direction
  const float* dy;
  const float* dz;
  const float* nx;          // (P,) the shade pass's normal
  const float* ny;
  const float* nz;
  const float* ar;          // (P,) its albedo
  const float* ag;
  const float* ab;
  const int* occ;           // (P,) the shadow march's hit flag, or null: no shadows
  LightVecs light;
  ColorSettings look;
  float* color;             // (P, 3)
  float* depth;             // (P,) or null
  float* normal;            // (P, 3) or null
  int p;
};

__global__ void __launch_bounds__(COLOR_THREADS) shade_color_kernel(const ColorArgs a) {
  const long long i = (long long)blockIdx.x * COLOR_THREADS + threadIdx.x;
  if (i >= a.p) return;
  const bool hit = __ldg(a.hit + i) != 0;
  ShadeData d = miss_shade();
  float dx = 0.0f, dy = 0.0f, t = 0.0f;
  bool occ = false;
  if (hit) {
    d.nx = __ldg(a.nx + i);
    d.ny = __ldg(a.ny + i);
    d.nz = __ldg(a.nz + i);
    d.ar = __ldg(a.ar + i);
    d.ag = __ldg(a.ag + i);
    d.ab = __ldg(a.ab + i);
    if (a.look.phong) {
      dx = __ldg(a.dx + i);
      dy = __ldg(a.dy + i);
    }
    if (a.look.fog || a.depth != nullptr) t = __ldg(a.t_hit + i);
    if (a.occ != nullptr) occ = __ldg(a.occ + i) != 0;
  }
  const PixelColor c = shade_color(d, dx, dy, __ldg(a.dz + i), hit, t, occ, a.light, a.look);
  a.color[i * 3 + 0] = c.r;
  a.color[i * 3 + 1] = c.g;
  a.color[i * 3 + 2] = c.b;
  if (a.depth != nullptr) a.depth[i] = c.depth;
  if (a.normal != nullptr) {
    a.normal[i * 3 + 0] = c.nx;
    a.normal[i * 3 + 1] = c.ny;
    a.normal[i * 3 + 2] = c.nz;
  }
}

}  // namespace

// occ: null without shadows; the light's five vectors: 3 floats each on the
// device; depth and normal: null without aux buffers.
extern "C" int hmrt_shade_color(const int* hit, const float* t_hit, const float* dx,
                                const float* dy, const float* dz, const float* nx,
                                const float* ny, const float* nz, const float* ar,
                                const float* ag, const float* ab, const int* occ,
                                const float* sun, const float* sun_color, const float* sky_top,
                                const float* sky_horizon, const float* fog_color, float* color,
                                float* depth, float* normal, int p,
                                int phong, int fog, float ambient, float specular,
                                float shininess, float fog_density, void* stream) {
  if (p <= 0) return (int)cudaSuccess;
  const ColorArgs a{hit, t_hit, dx, dy, dz, nx, ny, nz, ar, ag, ab, occ,
                    LightVecs{sun, sun_color, sky_top, sky_horizon, fog_color},
                    ColorSettings{phong, fog, ambient, specular, shininess, fog_density},
                    color, depth, normal, p};
  const int blocks = (int)(((long long)p + COLOR_THREADS - 1) / COLOR_THREADS);
  shade_color_kernel<<<blocks, COLOR_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
