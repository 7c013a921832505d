// K3 matched filter: a depthwise FIR with each detection's own time-reversed
// polyphase-arm taps, decimated by sps, on the I and Q planes:
//   out[d, s] = sum_{k < K} z[d, sps*s + k] * taps[d, k]
// with samples past the region's end read as zeros.
//
// Replaces gr4_packet_modem_tpu/ops/matched_pallas.py::matched_filter_pallas
// (kernel _make_kernel). The TPU kernel put 128 detections in the lanes and
// slid phase-split windows through VMEM; here one thread computes one
// (detection, symbol) output.
//
// Bound: memory bandwidth. Each output costs 2K = 88 multiply-adds for
// 4 * sps = 16 bytes of new input per plane, about 5.5 FLOP per byte, far
// under the card's ratio. Design: block (d, y) covers kSyms output symbols of
// detection d. It stages that detection's K taps and the block's sample
// window (sps * (kSyms - 1) + K samples per plane, zero past R) in shared
// memory with coalesced loads, so each sample is read from device memory once
// although K / sps = 11 outputs use it. Each thread then sums its K products
// from shared memory in tap order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSyms = 128;  // output symbols per block = threads per block

__global__ void matched_filter_kernel(const float* __restrict__ zr,
                                      const float* __restrict__ zi,
                                      const float* __restrict__ taps,
                                      float* __restrict__ outr,
                                      float* __restrict__ outi,
                                      int region_len, int ntaps, int sps,
                                      int num_syms) {
  extern __shared__ float smem[];
  const int win = sps * (kSyms - 1) + ntaps;
  float* t = smem;
  float* wr = smem + ntaps;
  float* wi = wr + win;

  const int d = blockIdx.x;
  const int s0 = blockIdx.y * kSyms;
  const float* zrd = zr + static_cast<int64_t>(d) * region_len;
  const float* zid = zi + static_cast<int64_t>(d) * region_len;
  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) {
    t[k] = taps[static_cast<int64_t>(d) * ntaps + k];
  }
  const int64_t base = static_cast<int64_t>(sps) * s0;
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    const int64_t n = base + i;
    const bool in = n < region_len;
    wr[i] = in ? zrd[n] : 0.0f;
    wi[i] = in ? zid[n] : 0.0f;
  }
  __syncthreads();

  const int s = s0 + threadIdx.x;
  if (s >= num_syms) return;
  const float* pr = wr + sps * threadIdx.x;
  const float* pi = wi + sps * threadIdx.x;
  float ar = 0.0f, ai = 0.0f;
  for (int k = 0; k < ntaps; ++k) {
    ar = fmaf(pr[k], t[k], ar);
    ai = fmaf(pi[k], t[k], ai);
  }
  const int64_t o = static_cast<int64_t>(d) * num_syms + s;
  outr[o] = ar;
  outi[o] = ai;
}

}  // namespace

extern "C" int pm_matched_filter(const void* zr, const void* zi,
                                 const void* taps, void* outr, void* outi,
                                 int region_len, int ntaps, int sps,
                                 int num_syms, int d, void* stream) {
  const int win = sps * (kSyms - 1) + ntaps;
  const size_t smem = sizeof(float) * (ntaps + 2 * static_cast<size_t>(win));
  dim3 grid(d, (num_syms + kSyms - 1) / kSyms);
  matched_filter_kernel<<<grid, kSyms, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zr), static_cast<const float*>(zi),
      static_cast<const float*>(taps), static_cast<float*>(outr),
      static_cast<float*>(outi), region_len, ntaps, sps, num_syms);
  return static_cast<int>(cudaGetLastError());
}
