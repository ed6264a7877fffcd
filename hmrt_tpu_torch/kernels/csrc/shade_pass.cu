// Shade data for every lane: surface normal and albedo at the hit point.
//
// Replaces the TPU kernel hmrt_tpu/kernels/compact.py::_shade_pass_kernel
// (launched by compact.py::shade_pass). For a hit lane it reads the
// central-difference gradients (gx, gy) at the 4 corners of the hit cell
// (hx, hy), interpolates them bilinearly at the in-cell offsets (fx, fy)
// and normalises (-gx, -gy, 1); a textured scene also gets the bilinear
// RGB albedo from the planar (3, N*N) texture. Misses get the normal
// (0, 0, 1) and albedo 0.55. The TPU kernel's brick records, DMA loop and
// lane-shuffle gathers existed only because the TPU has no dynamic vector
// gather; here they are plain global loads.
//
// What bounds it on the H100: it is a gather bound by bytes (8 gradient
// and up to 12 albedo loads per hit, scattered by hit cell) with almost no
// arithmetic. What this design does about it: nothing yet, on purpose; one
// thread per lane in launch order. Packing the corner gradients of a cell
// into one 16-byte load is later, measured work.
//
// The interpolation is written in the same expression order as the TPU
// kernel and the torch plain version, and the normalisation uses
// 1/sqrtf(x), not the approximate rsqrtf.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bilerp(float v00, float v10, float v01, float v11, float fx,
                                        float fy) {
  return v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy) + v01 * (1 - fx) * fy +
         v11 * fx * fy;
}

__global__ void shade_pass_kernel(const int* hit, const int* hx, const int* hy,
                                  const float* fx_p, const float* fy_p, const float* gx,
                                  const float* gy, const float* albedo, float* nx_o,
                                  float* ny_o, float* nz_o, float* ar_o, float* ag_o,
                                  float* ab_o, int p, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  float nx = 0.0f, ny = 0.0f, nz = 1.0f;
  float ar = 0.55f, ag = 0.55f, ab = 0.55f;
  if (hit[i]) {
    int cx = min(max(hx[i], 0), n - 2);
    int cy = min(max(hy[i], 0), n - 2);
    long long b = (long long)cy * n + cx;
    float fx = fx_p[i], fy = fy_p[i];
    float g_x = bilerp(gx[b], gx[b + 1], gx[b + n], gx[b + n + 1], fx, fy);
    float g_y = bilerp(gy[b], gy[b + 1], gy[b + n], gy[b + n + 1], fx, fy);
    float inv = 1.0f / sqrtf(g_x * g_x + g_y * g_y + 1.0f);
    nx = -g_x * inv;
    ny = -g_y * inv;
    nz = inv;
    if (albedo != nullptr) {
      long long nn = (long long)n * n;
      const float* r = albedo;
      const float* g = albedo + nn;
      const float* bl = albedo + 2 * nn;
      ar = bilerp(r[b], r[b + 1], r[b + n], r[b + n + 1], fx, fy);
      ag = bilerp(g[b], g[b + 1], g[b + n], g[b + n + 1], fx, fy);
      ab = bilerp(bl[b], bl[b + 1], bl[b + n], bl[b + n + 1], fx, fy);
    }
  }
  nx_o[i] = nx;
  ny_o[i] = ny;
  nz_o[i] = nz;
  ar_o[i] = ar;
  ag_o[i] = ag;
  ab_o[i] = ab;
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
