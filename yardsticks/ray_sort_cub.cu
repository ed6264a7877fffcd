// A yardstick for hmrt_tpu_torch/kernels/csrc/ray_sort.cu, not part of the
// port: the same sorted round with its radix passes (ray_sort_hist,
// ray_sort_scan, ray_sort_scatter) replaced by CUB's stable LSD radix sort,
// cub::DeviceRadixSort::SortPairs over the key's bits alone (begin_bit 0,
// end_bit ceil(log2(m5^2 + 1))), with int32 indices. The key pass and the
// gather are ray_sort.cu's own, so the two differ in the sort alone.
//
// chip_smoke.py::cub_library builds it beside a copy of ray_sort.cu named
// ray_sort.cuh (kernels/_build.py::build), and times it as the ray sort's
// library_ms.

#include <cub/device/device_radix_sort.cuh>

#include "ray_sort.cuh"

namespace {

__global__ void __launch_bounds__(THREADS) ray_sort_cub_iota(int* __restrict__ x, int p) {
  const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (k < p) x[k] = (int)k;
}

}  // namespace

// CUB's temporary storage, in bytes, for a round of p lanes keyed by m5.
extern "C" long long hmrt_ray_sort_cub_temp(int p, int m5) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, (const unsigned*)nullptr, (unsigned*)nullptr,
                                  (const int*)nullptr, (int*)nullptr, p, 0, plan_for(m5).bits);
  return (long long)bytes;
}

// hmrt_ray_sort's arguments, and CUB's temporary storage before the stream.
extern "C" int hmrt_ray_sort_cub(const int* alive, const float* t, const int* lvl,
                                 const int* icx, const int* icy, const float* ox,
                                 const float* oy, const float* dx, const float* dy,
                                 const void* const* src, void* const* dst, int n_extra,
                                 void* const* state_o, const int* perm_in, int* perm_out,
                                 int* flag, int* scratch, int scratch_n, int p, int m5,
                                 int tail_mode, float thresh, void* temp, long long temp_bytes,
                                 void* stream) {
  const Round r = make_round(alive, t, lvl, icx, icy, ox, oy, dx, dy, src, dst, n_extra,
                             state_o, perm_in, perm_out, flag, scratch, p, m5, tail_mode,
                             thresh, stream);
  if (!round_ok(r, scratch_n) || temp_bytes < hmrt_ray_sort_cub_temp(p, m5))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  launch_key(r);
  ray_sort_cub_iota<<<blocks_for(p), THREADS, 0, r.st>>>(r.s.idx_a, p);
  size_t bytes = (size_t)temp_bytes;
  const cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, bytes, reinterpret_cast<const unsigned*>(r.s.key_a),
      reinterpret_cast<unsigned*>(r.s.key_b), r.s.idx_a, r.s.perm, p, 0, r.plan.bits, r.st);
  if (err != cudaSuccess) return (int)err;
  launch_gather(r);
  return (int)cudaGetLastError();
}
