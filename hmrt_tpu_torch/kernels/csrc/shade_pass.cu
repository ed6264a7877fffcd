// Shade data for every lane: surface normal and albedo at the hit point.
//
// Replaces the TPU kernel hmrt_tpu/kernels/compact.py::_shade_pass_kernel
// (launched by compact.py::shade_pass). For a hit lane it reads the
// central-difference gradients (gx, gy) at the 4 corners of the hit cell
// (hx, hy), interpolates them bilinearly at the in-cell offsets (fx, fy)
// and normalises (-gx, -gy, 1); a textured scene also gets the bilinear
// RGB albedo from the planar (3, N*N) texture (shade_common.cuh). Misses
// get the normal (0, 0, 1) and albedo 0.55. The TPU kernel's brick
// records, DMA loop and lane-shuffle gathers existed only because the TPU
// has no dynamic vector gather; here they are plain global loads.
//
// What bounds it on the H100: it is a gather bound by bytes (8 gradient
// and up to 12 albedo loads per hit, scattered by hit cell) with almost no
// arithmetic. What this design does about it: nothing yet, on purpose; one
// thread per lane in launch order. Packing the corner gradients of a cell
// into one 16-byte load is later, measured work.

#include <cuda_runtime.h>

#include "shade_common.cuh"

namespace {

__global__ void shade_pass_kernel(const int* hit, const int* hx, const int* hy,
                                  const float* fx_p, const float* fy_p, const float* gx,
                                  const float* gy, const float* albedo, float* nx_o,
                                  float* ny_o, float* nz_o, float* ar_o, float* ag_o,
                                  float* ab_o, int p, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  ShadeData d = shade_lane(hit[i] != 0, hx[i], hy[i], fx_p[i], fy_p[i], gx, gy, albedo, n);
  nx_o[i] = d.nx;
  ny_o[i] = d.ny;
  nz_o[i] = d.nz;
  ar_o[i] = d.ar;
  ag_o[i] = d.ag;
  ab_o[i] = d.ab;
}

}  // namespace

extern "C" int hmrt_shade_pass(const int* hit, const int* hx, const int* hy, const float* fx,
                               const float* fy, const float* gx, const float* gy,
                               const float* albedo, float* nx, float* ny, float* nz,
                               float* ar, float* ag, float* ab, int p, int n, void* stream) {
  if (p <= 0) return (int)cudaSuccess;
  const int threads = 256;
  shade_pass_kernel<<<(p + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      hit, hx, hy, fx, fy, gx, gy, albedo, nx, ny, nz, ar, ag, ab, p, n);
  return (int)cudaGetLastError();
}
