// K3 matched filter: a depthwise FIR with each detection's own time-reversed
// polyphase-arm taps, decimated by sps, on the I and Q planes:
//   out[d, s] = sum_{k < K} z[d, sps*s + k] * taps[d, k]
// with samples past the region's end read as zeros.
//
// Replaces gr4_packet_modem_tpu/ops/matched_pallas.py::matched_filter_pallas
// (kernel _make_kernel). The TPU kernel put 128 detections in the lanes and
// slid phase-split windows through VMEM.
//
// Bound: memory bandwidth. Each output costs 2K = 88 multiply-adds for
// 4 * sps = 16 bytes of new input per plane, about 5.5 FLOP per byte, far
// under the card's ratio. A first version, one output a thread summing its K
// products from a shared window with a stride of sps between threads, was
// bound by shared memory instead: 4-way bank conflicts on 2/3 of its loads
// and K loads an output.
// Design: block (d, chunk) covers kQ * blockDim.x output symbols of detection
// d. It stages the detection's taps (zero past K) and the chunk's sample
// window (zero past R) in shared memory, de-interleaved by phase,
// ph[p][m] = w[sps m + p], with coalesced loads (a float4 a symbol when
// sps = 4 and the rows are 16-byte aligned), so each sample is read from
// device memory once. Then out[s] = sum_p sum_q ph[p][s + q] taps[sps q + p]:
// each thread computes kQ consecutive outputs from a sliding window of
// kQ + ceil(K/sps) - 1 values of each phase held in registers, so it loads
// each staged sample about once, and the taps are broadcasts. kQ is odd, so
// the threads' strided window loads fall on distinct banks, and a phase's
// row length is 8 mod 32, so the de-interleaving stores do too (sps = 4).
// The outputs leave through shared memory, coalesced. Measured on the card
// at the payload shape: 9 outputs a thread with float4 loads beat 5, 7, 11
// and 13, and scalar loads; 256 threads a block gained nothing. The sum
// runs over p,
// then q: another order than k, within float32 rounding
// (tests: rtol 1e-5, atol 1e-4). The receiver's shape (sps = 4,
// ceil(K/sps) = 11) is compiled with both as constants; any other sps and K
// take the same kernel with both read at run time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 9;          // consecutive outputs a thread computes (odd)
constexpr int kThreads = 128;  // most threads a block

__host__ __device__ inline int phase_row(int cs, int kq) {
  const int pl = cs + kq - 1;  // a phase's values a chunk needs
  return ((pl + 31) & ~31) + 8;
}

// kSps, kKQ: sps and ceil(K / sps) as constants, or 0 to read them at run time
template <int kSps, int kKQ>
__global__ void __launch_bounds__(kThreads)
matched_filter_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                      const float* __restrict__ taps, float* __restrict__ outr,
                      float* __restrict__ outi, int region_len, int ntaps,
                      int sps_rt, int num_syms, int chunks) {
  extern __shared__ float smem[];
  const int sps = kSps > 0 ? kSps : sps_rt;
  const int kq = kKQ > 0 ? kKQ : (ntaps + sps - 1) / sps;
  const int nt = blockDim.x;
  const int cs = nt * kQ;
  const int plp = phase_row(cs, kq);
  float* tq = smem;
  float* wr = smem + kq * sps;
  float* wi = wr + sps * plp;

  const int d = blockIdx.x / chunks;
  const int s0 = (blockIdx.x % chunks) * cs;
  for (int k = threadIdx.x; k < kq * sps; k += nt) {
    tq[k] = k < ntaps ? taps[static_cast<int64_t>(d) * ntaps + k] : 0.0f;
  }
  const float* zrd = zr + static_cast<int64_t>(d) * region_len;
  const float* zid = zi + static_cast<int64_t>(d) * region_len;
  const int64_t base = static_cast<int64_t>(sps) * s0;
  const int win = sps * (cs + kq - 1);
  const bool aligned = (region_len & 3) == 0 &&
                       ((reinterpret_cast<uintptr_t>(zr) | reinterpret_cast<uintptr_t>(zi)) & 15) == 0;
  if (kSps == 4 && aligned) {
    // one symbol's four phases a float4 (the rows are 16-byte aligned)
    const float4* zr4 = reinterpret_cast<const float4*>(zrd + base);
    const float4* zi4 = reinterpret_cast<const float4*>(zid + base);
    const int syms = win / 4;
    const int64_t have = (region_len - base) / 4;
#pragma unroll 4
    for (int m = threadIdx.x; m < syms; m += nt) {
      const bool in = m < have;
      const float4 a = in ? zr4[m] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = in ? zi4[m] : make_float4(0.f, 0.f, 0.f, 0.f);
      wr[m] = a.x; wr[plp + m] = a.y; wr[2 * plp + m] = a.z; wr[3 * plp + m] = a.w;
      wi[m] = b.x; wi[plp + m] = b.y; wi[2 * plp + m] = b.z; wi[3 * plp + m] = b.w;
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < win; i += nt) {
      const int64_t n = base + i;
      const bool in = n < region_len;
      const int a = (i % sps) * plp + i / sps;
      wr[a] = in ? zrd[n] : 0.0f;
      wi[a] = in ? zid[n] : 0.0f;
    }
  }
  __syncthreads();

  float acc_r[kQ], acc_i[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) acc_r[i] = acc_i[i] = 0.0f;
  for (int p = 0; p < sps; ++p) {
    const float* pr = wr + p * plp + kQ * threadIdx.x;
    const float* pi = wi + p * plp + kQ * threadIdx.x;
    if constexpr (kKQ > 0) {
      float vr[kQ + kKQ - 1], vi[kQ + kKQ - 1];
#pragma unroll
      for (int i = 0; i < kQ + kKQ - 1; ++i) {
        vr[i] = pr[i];
        vi[i] = pi[i];
      }
#pragma unroll
      for (int q = 0; q < kKQ; ++q) {
        const float tap = tq[q * sps + p];
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          acc_r[i] = fmaf(vr[i + q], tap, acc_r[i]);
          acc_i[i] = fmaf(vi[i + q], tap, acc_i[i]);
        }
      }
    } else {
      for (int q = 0; q < kq; ++q) {
        const float tap = tq[q * sps + p];
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          acc_r[i] = fmaf(pr[i + q], tap, acc_r[i]);
          acc_i[i] = fmaf(pi[i + q], tap, acc_i[i]);
        }
      }
    }
  }
  __syncthreads();  // the window is read; its space takes the outputs
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    wr[kQ * threadIdx.x + i] = acc_r[i];
    wi[kQ * threadIdx.x + i] = acc_i[i];
  }
  __syncthreads();
  const int64_t o = static_cast<int64_t>(d) * num_syms + s0;
  const int valid = min(cs, num_syms - s0);
  for (int k = threadIdx.x; k < valid; k += nt) {
    outr[o + k] = wr[k];
    outi[o + k] = wi[k];
  }
}

template <int kSps, int kKQ>
int launch(const void* zr, const void* zi, const void* taps, void* outr, void* outi,
           int region_len, int ntaps, int sps, int num_syms, int d,
           cudaStream_t stream) {
  const int kq = (ntaps + sps - 1) / sps;
  // threads: enough for num_syms in warps, at most kThreads
  const int want = (num_syms + kQ - 1) / kQ;
  const int nt = want >= kThreads ? kThreads : ((want + 31) / 32) * 32;
  const int cs = nt * kQ;
  const int chunks = (num_syms + cs - 1) / cs;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kq) * sps +
                                       2 * static_cast<size_t>(sps) * phase_row(cs, kq));
  if (static_cast<int64_t>(chunks) * d > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(matched_filter_kernel<kSps, kKQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  matched_filter_kernel<kSps, kKQ><<<chunks * d, nt, smem, stream>>>(
      static_cast<const float*>(zr), static_cast<const float*>(zi),
      static_cast<const float*>(taps), static_cast<float*>(outr),
      static_cast<float*>(outi), region_len, ntaps, sps, num_syms, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pm_matched_filter(const void* zr, const void* zi,
                                 const void* taps, void* outr, void* outi,
                                 int region_len, int ntaps, int sps,
                                 int num_syms, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sps == 4 && (ntaps + 3) / 4 == 11) {
    return launch<4, 11>(zr, zi, taps, outr, outi, region_len, ntaps, sps, num_syms, d, st);
  }
  return launch<0, 0>(zr, zi, taps, outr, outi, region_len, ntaps, sps, num_syms, d, st);
}
