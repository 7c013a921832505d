// K2 region fetch: a bit-exact copy of D windows x[s_d : s_d + R] from the I
// and Q sample planes into [D, R] outputs.
//
// Replaces gr4_packet_modem_tpu/ops/fetch_pallas.py::fetch_regions (the
// kernel _kernel, launched by pl.pallas_call in _fetch_regions_impl). On the
// TPU that kernel needed scalar-prefetched starts, 1024-aligned DMA windows
// and one-hot selection matmuls to shift the window into place. None of that
// carries over: a GPU thread can load from any address.
//
// Bound: device memory bandwidth. The copy does no arithmetic; at the payload
// shape (D = 1536, R = 24,680) it moves 2 x 152 MB in and the same out.
// Design: grid (D, Y). Block (d, y) reads its own start and copies a strided
// slice of the region, so neighbouring threads touch neighbouring addresses
// and every load and store is coalesced. Y splits long regions across blocks
// so there are enough blocks in flight at every R. Starts are clamped to
// [0, T - R], like a dynamic slice, so no start can read out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerBlock = kThreads * 16;  // elements per plane per block

__global__ void fetch_regions_kernel(const float* __restrict__ xr,
                                     const float* __restrict__ xi,
                                     const int64_t* __restrict__ starts,
                                     float* __restrict__ outr,
                                     float* __restrict__ outi,
                                     int64_t total_len, int region_len) {
  const int d = blockIdx.x;
  int64_t s = starts[d];
  const int64_t hi = total_len - region_len;
  s = s < 0 ? 0 : (s > hi ? hi : s);
  const float* src_r = xr + s;
  const float* src_i = xi + s;
  float* dst_r = outr + static_cast<int64_t>(d) * region_len;
  float* dst_i = outi + static_cast<int64_t>(d) * region_len;
  const int stride = gridDim.y * blockDim.x;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < region_len;
       i += stride) {
    dst_r[i] = src_r[i];
    dst_i[i] = src_i[i];
  }
}

}  // namespace

extern "C" int pm_fetch_regions(const void* xr, const void* xi,
                                const void* starts, void* outr, void* outi,
                                long long total_len, int region_len, int d,
                                void* stream) {
  int y = (region_len + kPerBlock - 1) / kPerBlock;
  if (y < 1) y = 1;
  if (y > 65535) y = 65535;
  dim3 grid(d, y);
  fetch_regions_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int64_t*>(starts), static_cast<float*>(outr),
      static_cast<float*>(outi), static_cast<int64_t>(total_len), region_len);
  return static_cast<int>(cudaGetLastError());
}
