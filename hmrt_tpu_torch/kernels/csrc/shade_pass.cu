// Shade data for every lane: surface normal and albedo at the hit point.
//
// Replaces the TPU kernel hmrt_tpu/kernels/compact.py::_shade_pass_kernel
// (launched by compact.py::shade_pass). For a hit lane it interpolates the
// central-difference gradients at the 4 corners of the hit cell (hx, hy)
// bilinearly at the in-cell offsets (fx, fy) and normalises (-gx, -gy, 1);
// a textured scene also gets the bilinear RGB albedo of the cell's corners
// (shade_common.cuh). Misses get the normal (0, 0, 1) and albedo 0.55. The
// TPU kernel's DMA loop over bricks and its lane-shuffle gathers existed
// because the TPU has no dynamic vector gather; here each lane loads its
// own cell.
//
// What bounds it on the H100: it is a gather, bound by the 32-byte sectors
// it pulls from device memory, with ~80 operations a hit. The hits of a
// frame rarely share a sector (B4: ~921,600 lanes on ~2.5 M distinct corner
// samples). Read from the (N, N) planes, one hit touched two rows of each
// of 2 planes (5 textured): ~4.5 sectors for 32 useful bytes, ~11 for 80.
//
// What this design does about it: the per-cell records of the JAX
// package's shade and albedo bricks (kernels/packing.py), laid out as an
// array of structs (api/scene.py shade_records). A cell's 8 corner
// gradients are one 32-byte record, one sector, read as two float4 loads;
// its 12 corner RGB values are a 48-byte record, two sectors, read as
// three. A hit issues all of its record loads through the read-only path
// before any arithmetic, so that they are in flight together; a miss reads
// only its hit flag. Shared memory, TMA and the tensor cores have nothing
// to offer a gather this scattered. Two lanes a thread were measured no
// faster on the H100 (PERF.md).
//
// Exactness: the arithmetic of the torch plain version in its order; the
// build's -fmad=false -prec-div=true -prec-sqrt=true keep it bit for bit.

#include <cuda_runtime.h>

#include "shade_common.cuh"

namespace {

constexpr int SHADE_THREADS = 256;  // threads per block, one lane each

template <bool kTextured>
__global__ void __launch_bounds__(SHADE_THREADS)
    shade_pass_kernel(const int* __restrict__ hit, const int* __restrict__ hx,
                      const int* __restrict__ hy, const float* __restrict__ fx_p,
                      const float* __restrict__ fy_p, const float4* __restrict__ shade_rec,
                      const float4* __restrict__ albedo_rec, float* __restrict__ nx_o,
                      float* __restrict__ ny_o, float* __restrict__ nz_o,
                      float* __restrict__ ar_o, float* __restrict__ ag_o,
                      float* __restrict__ ab_o, int p, int c) {
  const long long i = (long long)blockIdx.x * SHADE_THREADS + threadIdx.x;
  if (i >= p) return;
  ShadeData d = miss_shade();
  if (__ldg(hit + i) != 0) {
    const int cx = min(max(__ldg(hx + i), 0), c - 1);
    const int cy = min(max(__ldg(hy + i), 0), c - 1);
    const float fx = __ldg(fx_p + i), fy = __ldg(fy_p + i);
    const long long cell = (long long)cy * c + cx;
    float4 g[2], a[3];
    g[0] = __ldg(shade_rec + 2 * cell);
    g[1] = __ldg(shade_rec + 2 * cell + 1);
    if (kTextured) {
      a[0] = __ldg(albedo_rec + 3 * cell);
      a[1] = __ldg(albedo_rec + 3 * cell + 1);
      a[2] = __ldg(albedo_rec + 3 * cell + 2);
    }
    d = shade_records(g, kTextured ? a : nullptr, fx, fy);
  }
  nx_o[i] = d.nx;
  ny_o[i] = d.ny;
  nz_o[i] = d.nz;
  ar_o[i] = d.ar;
  ag_o[i] = d.ag;
  ab_o[i] = d.ab;
}

}  // namespace

// shade_rec: (c, c, 8) f32; albedo_rec: (c, c, 12) f32 or null (untextured).
extern "C" int hmrt_shade_pass(const int* hit, const int* hx, const int* hy, const float* fx,
                               const float* fy, const float* shade_rec,
                               const float* albedo_rec, float* nx, float* ny, float* nz,
                               float* ar, float* ag, float* ab, int p, int c, void* stream) {
  if (p <= 0) return (int)cudaSuccess;
  const int blocks = (int)(((long long)p + SHADE_THREADS - 1) / SHADE_THREADS);
  const float4* g = reinterpret_cast<const float4*>(shade_rec);
  const float4* a = reinterpret_cast<const float4*>(albedo_rec);
  cudaStream_t s = (cudaStream_t)stream;
  if (albedo_rec != nullptr)
    shade_pass_kernel<true><<<blocks, SHADE_THREADS, 0, s>>>(hit, hx, hy, fx, fy, g, a, nx, ny,
                                                             nz, ar, ag, ab, p, c);
  else
    shade_pass_kernel<false><<<blocks, SHADE_THREADS, 0, s>>>(hit, hx, hy, fx, fy, g, a, nx, ny,
                                                              nz, ar, ag, ab, p, c);
  return (int)cudaGetLastError();
}
