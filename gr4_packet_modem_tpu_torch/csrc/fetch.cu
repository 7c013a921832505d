// K2 region fetch: a bit-exact copy of D windows x[s_d : s_d + R] from the I
// and Q sample planes into [D, R] outputs; K2b, the same copy from one plane.
//
// Replaces gr4_packet_modem_tpu/ops/fetch_pallas.py::fetch_regions (the
// kernel _kernel, launched by pl.pallas_call in _fetch_regions_impl) and
// fetch_rows (_kernel1, in _fetch_rows_impl). On the TPU those kernels
// needed scalar-prefetched starts, 1024-aligned DMA windows and one-hot
// selection matmuls to shift the window into place. None of that carries
// over: a GPU thread can load from any address.
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

// Block (d, y) copies its share of region d from xr, and from xi when
// kPlanes is 2 (K2); kPlanes 1 is the single-plane K2b.
template <int kPlanes>
__global__ void fetch_kernel(const float* __restrict__ xr,
                             const float* __restrict__ xi,
                             const int64_t* __restrict__ starts,
                             float* __restrict__ outr,
                             float* __restrict__ outi, int64_t total_len,
                             int region_len) {
  const int d = blockIdx.x;
  int64_t s = starts[d];
  const int64_t hi = total_len - region_len;
  s = s < 0 ? 0 : (s > hi ? hi : s);
  const float* src_r = xr + s;
  float* dst_r = outr + static_cast<int64_t>(d) * region_len;
  const int stride = gridDim.y * blockDim.x;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < region_len;
       i += stride) {
    dst_r[i] = src_r[i];
    if (kPlanes == 2) {
      outi[static_cast<int64_t>(d) * region_len + i] = xi[s + i];
    }
  }
}

dim3 fetch_grid(int region_len, int d) {
  int y = (region_len + kPerBlock - 1) / kPerBlock;
  if (y < 1) y = 1;
  if (y > 65535) y = 65535;
  return dim3(d, y);
}

}  // namespace

extern "C" int pm_fetch_regions(const void* xr, const void* xi,
                                const void* starts, void* outr, void* outi,
                                long long total_len, int region_len, int d,
                                void* stream) {
  fetch_kernel<2><<<fetch_grid(region_len, d), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const int64_t*>(starts), static_cast<float*>(outr),
      static_cast<float*>(outi), static_cast<int64_t>(total_len), region_len);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pm_fetch_rows(const void* x, const void* starts, void* out,
                             long long total_len, int region_len, int d,
                             void* stream) {
  fetch_kernel<1><<<fetch_grid(region_len, d), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), nullptr,
      static_cast<const int64_t*>(starts), static_cast<float*>(out), nullptr,
      static_cast<int64_t>(total_len), region_len);
  return static_cast<int>(cudaGetLastError());
}
