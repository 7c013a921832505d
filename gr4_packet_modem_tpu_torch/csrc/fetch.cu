// K2 region fetch: a bit-exact copy of D windows x[s_d : s_d + R] of the
// complex64 sample bank, read as it lies (interleaved I and Q), into [D, R]
// I and Q planes. K2b row fetch: D windows of one float32 plane into [D, R].
//
// Replaces gr4_packet_modem_tpu/ops/fetch_pallas.py::fetch_regions (the
// kernel _kernel, launched by pl.pallas_call in _fetch_regions_impl) and
// fetch_rows (_kernel1, in _fetch_rows_impl). The TPU cannot gather complex
// values, so its kernel read two float32 planes that every caller split off
// the bank first; on the TPU it also needed scalar-prefetched starts,
// 1024-aligned DMA windows and one-hot matmuls to shift a window into place.
// A Hopper thread loads an 8-byte complex sample from any address, so K2
// reads the bank itself and the callers split nothing.
//
// Bound: device memory bandwidth. K2 reads D*R*8 bytes and writes D*R*8
// (at the payload shape D = 1536, R = 24,680: 303 MB each way); K2b moves
// D*R*4 each way, at the main path's R = 3 far too little for any bound but
// a launch's.
//
// Design, K2. The work is flat over the [D, R] output in items of kRun = 4
// consecutive output samples, so no block idles on the short rows of the
// header pass (R = 808) and the grid is sized to the items, not to the
// rows. Every item is stored as one 16-byte float4 a plane: it starts at a
// multiple of 4 of the flat output, which is a fresh allocation, at any R
// (an odd R = 1569 too; only the output's last item, when D * R % 4 != 0,
// is stored sample by sample). An item that lies in one row loads its run
// as two 16-byte float4 (I0 Q0 I1 Q1, I2 Q2 I3 Q3) where the run starts
// 16-byte aligned, that is where the address of x + s + c is even in
// samples, else as four 8-byte float2; either way neighbouring threads
// read neighbouring 32-byte sectors. An item that runs into the next row
// (one a row when R % 4 != 0) loads sample by sample from each row's own
// window, so no load passes a window's end. Starts are clamped to
// [0, T - R], like a dynamic slice. The grid is the wrapper's
// (ops/fetch_cuda.py::fetch_plan); the loop strides over it.
//
// Design, K2b. One thread an output element, flat over [D, R], so stores
// are coalesced across rows and R = 3 takes a few blocks, not D.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block, both kernels
constexpr int kRun = 4;        // consecutive output samples a K2 item copies

__device__ __forceinline__ long long clamp_start(long long s, long long hi) {
  return s < 0 ? 0 : (s > hi ? hi : s);
}

__global__ void __launch_bounds__(kThreads)
    fetch_regions_kernel(const float2* __restrict__ x,
                         const int64_t* __restrict__ starts,
                         float* __restrict__ outr, float* __restrict__ outi,
                         long long total_len, int region_len,
                         unsigned elements, unsigned items) {
  const long long hi = total_len - region_len;
  const unsigned r = static_cast<unsigned>(region_len);
  for (unsigned item = blockIdx.x * kThreads + threadIdx.x; item < items;
       item += gridDim.x * kThreads) {
    const unsigned e0 = item * kRun;  // first flat output sample
    const unsigned d0 = e0 / r;
    const unsigned c0 = e0 - d0 * r;
    float re[kRun] = {}, im[kRun] = {};
    if (c0 + kRun <= r) {  // the run lies in row d0
      const float2* src = x + clamp_start(starts[d0], hi) + c0;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float4 b = reinterpret_cast<const float4*>(src)[1];
        re[0] = a.x; im[0] = a.y; re[1] = a.z; im[1] = a.w;
        re[2] = b.x; im[2] = b.y; re[3] = b.z; im[3] = b.w;
      } else {
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const float2 v = src[k];
          re[k] = v.x;
          im[k] = v.y;
        }
      }
    } else {  // the run crosses a row's end, or ends the output
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (e0 + k < elements) {
          const unsigned dk = d0 + (c0 + k) / r;
          const float2 v = x[clamp_start(starts[dk], hi) + (e0 + k - dk * r)];
          re[k] = v.x;
          im[k] = v.y;
        }
      }
    }
    if (e0 + kRun <= elements) {
      *reinterpret_cast<float4*>(outr + e0) =
          make_float4(re[0], re[1], re[2], re[3]);
      *reinterpret_cast<float4*>(outi + e0) =
          make_float4(im[0], im[1], im[2], im[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (e0 + k < elements) {
          outr[e0 + k] = re[k];
          outi[e0 + k] = im[k];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fetch_rows_kernel(const float* __restrict__ x,
                      const int64_t* __restrict__ starts,
                      float* __restrict__ out, long long total_len,
                      int region_len, unsigned items) {
  const long long hi = total_len - region_len;
  const unsigned r = static_cast<unsigned>(region_len);
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < items;
       e += gridDim.x * kThreads) {
    const unsigned d = e / r;
    out[e] = x[clamp_start(starts[d], hi) + (e - d * r)];
  }
}

}  // namespace

extern "C" int pm_fetch_regions(const void* x, const void* starts, void* outr,
                                void* outi, long long total_len,
                                int region_len, int d, int blocks,
                                void* stream) {
  const unsigned elements =
      static_cast<unsigned>(region_len) * static_cast<unsigned>(d);
  fetch_regions_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const int64_t*>(starts),
      static_cast<float*>(outr), static_cast<float*>(outi), total_len,
      region_len, elements, (elements + kRun - 1) / kRun);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pm_fetch_rows(const void* x, const void* starts, void* out,
                             long long total_len, int region_len, int d,
                             int blocks, void* stream) {
  fetch_rows_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int64_t*>(starts),
      static_cast<float*>(out), total_len, region_len,
      static_cast<unsigned>(region_len) * static_cast<unsigned>(d));
  return static_cast<int>(cudaGetLastError());
}
