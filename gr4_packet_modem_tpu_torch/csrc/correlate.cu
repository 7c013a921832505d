// K1 fused correlator: overlap-save correlation of every frame against nb
// replica spectra, reduced over the bins to the best power and its bin:
//   best_pow[f, j] = max_b |ifft(fft(frame_f) * R_b)[j]|^2,  best_bin = argmax
// with ifft's 1/N folded in, as torch.fft.ifft does. Frame f is row f of the
// body plane a (S samples) followed by the first N - S samples of row f of the
// one-stride-shifted plane b.
//
// Replaces gr4_packet_modem_tpu/ops/acquire_pallas.py::fused_best_power (the
// kernels _make_kernel and _make_kernel_wide, launched by pl.pallas_call). The
// TPU kernel factored both DFTs as N = 16 x N2 matmuls for the MXU; on the GPU
// a transform with data exchange inside the block is an FFT in shared memory.
//
// Bound: shared memory traffic and synchronisation. At the bench shape (20,480
// frames, N = 2048, 9 bins) the kernel reads 0.34 GB and writes 0.34 GB of
// device memory, while its ten radix-2 transforms per frame make 2.3e9
// butterflies, each of which loads and stores two complex values in shared
// memory. What it saves is the fft path's device memory traffic: that path
// materialises the [frames, 9, N] complex product several times (3 GB each).
// Design: one block per frame, 512 threads. The frame is assembled from the
// two plane views in shared memory; a decimation-in-frequency FFT turns it in
// place into its spectrum in bit-reversed order, which stays in shared memory.
// Each bin then multiplies a copy of it by R_b (pre-permuted into bit-reversed
// order by the wrapper, read through L2), runs a decimation-in-time inverse
// FFT in place, which leaves natural order, and folds |y|^2 into a running
// max/argmax held in registers (strict >, from -1, so the lowest bin wins a
// tie, as in the TPU kernel). Twiddles come from a table computed in float64
// on the host, one row per stage so that neighbouring butterflies read
// neighbouring entries; no fast math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(w) * a
__device__ __forceinline__ float2 cmulc(float2 a, float2 w) {
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}

// tw holds, for the stage whose butterflies span 2h points, the h twiddles
// exp(-2 pi i p / (2h)), p < h, at tw[h + p] (h = 1, 2, ..., N/2).
template <int kLog2N>
__global__ void __launch_bounds__(kThreads)
correlate_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ br, const float* __restrict__ bi,
                 const float2* __restrict__ rf, const float2* __restrict__ tw,
                 float* __restrict__ out_pow, int* __restrict__ out_bin, int s,
                 int nb) {
  constexpr int kN = 1 << kLog2N;
  constexpr int kHalf = kN / 2;
  constexpr int kPer = kN / kThreads;  // outputs per thread
  extern __shared__ float2 smem[];
  float2* spec = smem;
  float2* work = smem + kN;
  float2* tws = smem + 2 * kN;

  const int tid = threadIdx.x;
  const int64_t f = blockIdx.x;
  for (int k = tid; k < kN; k += kThreads) tws[k] = tw[k];
  const float* a_r = ar + f * s;
  const float* a_i = ai + f * s;
  const float* b_r = br + f * s;
  const float* b_i = bi + f * s;
  for (int j = tid; j < kN; j += kThreads) {
    spec[j] = j < s ? make_float2(a_r[j], a_i[j])
                    : make_float2(b_r[j - s], b_i[j - s]);
  }
  __syncthreads();

  // forward FFT, decimation in frequency: natural in, bit-reversed out
  for (int lh = kLog2N - 1; lh >= 0; --lh) {
    const int h = 1 << lh;
    for (int t = tid; t < kHalf; t += kThreads) {
      const int p = t & (h - 1);
      const int i = ((t >> lh) << (lh + 1)) + p;
      const float2 x0 = spec[i];
      const float2 x1 = spec[i + h];
      spec[i] = make_float2(x0.x + x1.x, x0.y + x1.y);
      spec[i + h] = cmul(make_float2(x0.x - x1.x, x0.y - x1.y), tws[h + p]);
    }
    __syncthreads();
  }

  float pmax[kPer];
  int pbin[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    pmax[k] = -1.0f;
    pbin[k] = 0;
  }
  // 1/N^2 on the power is 1/N on the inverse transform: exact, N is 2^k
  const float inv_n2 = 1.0f / (static_cast<float>(kN) * static_cast<float>(kN));
  for (int b = 0; b < nb; ++b) {
    const float2* r = rf + static_cast<int64_t>(b) * kN;
    for (int j = tid; j < kN; j += kThreads) work[j] = cmul(spec[j], r[j]);
    __syncthreads();
    // inverse FFT, decimation in time: bit-reversed in, natural out
    for (int lh = 0; lh < kLog2N; ++lh) {
      const int h = 1 << lh;
      for (int t = tid; t < kHalf; t += kThreads) {
        const int p = t & (h - 1);
        const int i = ((t >> lh) << (lh + 1)) + p;
        const float2 x0 = work[i];
        const float2 x1 = cmulc(work[i + h], tws[h + p]);
        work[i] = make_float2(x0.x + x1.x, x0.y + x1.y);
        work[i + h] = make_float2(x0.x - x1.x, x0.y - x1.y);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float2 y = work[tid + k * kThreads];
      const float p = (y.x * y.x + y.y * y.y) * inv_n2;
      if (p > pmax[k]) {
        pmax[k] = p;
        pbin[k] = b;
      }
    }
    __syncthreads();  // the next bin overwrites work
  }
  float* op = out_pow + f * kN;
  int* ob = out_bin + f * kN;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    op[tid + k * kThreads] = pmax[k];
    ob[tid + k * kThreads] = pbin[k];
  }
}

template <int kLog2N>
int launch(const void* ar, const void* ai, const void* br, const void* bi,
           const void* rf, const void* tw, void* out_pow, void* out_bin,
           int fpad, int s, int nb, cudaStream_t stream) {
  const size_t smem = sizeof(float2) * 3 * (static_cast<size_t>(1) << kLog2N);
  cudaError_t err = cudaFuncSetAttribute(
      correlate_kernel<kLog2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  correlate_kernel<kLog2N><<<fpad, kThreads, smem, stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(ai),
      static_cast<const float*>(br), static_cast<const float*>(bi),
      static_cast<const float2*>(rf), static_cast<const float2*>(tw),
      static_cast<float*>(out_pow), static_cast<int*>(out_bin), s, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// log2n in {11, 12, 13}: N = 2048, 4096 or 8192 (the wrapper checks it).
extern "C" int pm_correlate(const void* ar, const void* ai, const void* br,
                            const void* bi, const void* rf, const void* tw,
                            void* out_pow, void* out_bin, int fpad, int s,
                            int nb, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 11:
      return launch<11>(ar, ai, br, bi, rf, tw, out_pow, out_bin, fpad, s, nb, st);
    case 12:
      return launch<12>(ar, ai, br, bi, rf, tw, out_pow, out_bin, fpad, s, nb, st);
    case 13:
      return launch<13>(ar, ai, br, bi, rf, tw, out_pow, out_bin, fpad, s, nb, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
