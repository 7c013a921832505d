// K2 as it was before it read the complex bank: D windows x[s : s + R] of
// two float32 I and Q planes into [D, R] planes, grid (D, ceil(R / 4096))
// of 256 threads, each block copying a strided share of its window. Its
// callers split the complex64 bank into the two planes first. chip_smoke.py
// times that route (the two splits, then this kernel) beside K2 as the
// yardstick of what reading the bank as it lies saves. Built on its own,
// outside the port's library (ops/_build.py::build_single); not on any path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerBlock = kThreads * 16;  // elements per plane per block

__global__ void fetch_planes_kernel(const float* __restrict__ xr,
                                    const float* __restrict__ xi,
                                    const int64_t* __restrict__ starts,
                                    float* __restrict__ outr,
                                    float* __restrict__ outi,
                                    int64_t total_len, int region_len) {
  const int d = blockIdx.x;
  int64_t s = starts[d];
  const int64_t hi = total_len - region_len;
  s = s < 0 ? 0 : (s > hi ? hi : s);
  const int64_t o = static_cast<int64_t>(d) * region_len;
  const int stride = gridDim.y * blockDim.x;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < region_len;
       i += stride) {
    outr[o + i] = xr[s + i];
    outi[o + i] = xi[s + i];
  }
}

}  // namespace

extern "C" int pm_fetch_planes(const void* xr, const void* xi,
                               const void* starts, void* outr, void* outi,
                               long long total_len, int region_len, int d,
                               void* stream) {
  int y = (region_len + kPerBlock - 1) / kPerBlock;
  y = y < 1 ? 1 : (y > 65535 ? 65535 : y);
  fetch_planes_kernel<<<dim3(d, y), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int64_t*>(starts), static_cast<float*>(outr),
      static_cast<float*>(outi), static_cast<int64_t>(total_len), region_len);
  return static_cast<int>(cudaGetLastError());
}
