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
// a transform with data exchange inside the block is an FFT.
//
// Bound: arithmetic. At the bench shape (20,480 frames, N = 2048, 9 bins) the
// ten transforms per frame are about 26 GFLOP against 0.62 GB of device memory
// traffic. What held a radix-2 FFT in shared memory far from either was the
// shared-memory traffic of 11 stages a transform (two loads and two stores a
// butterfly) and a barrier per stage.
// Design: a mixed-radix transform with the points in registers. A frame is
// one block of N / 16 threads and each thread holds 16 complex points. Each
// pass runs radix-R butterflies on a thread's own points (radix 16, 16, 8 at
// N = 2048; 16, 16, 16 at 4096; 16, 16, 16, 2 at 8192), so a transform makes
// 2 or 3 exchanges through shared memory, each one store and one load a
// point and one barrier; exchanges alternate between two buffers. The
// buffers' float2 addresses are XOR-swizzled (p ^ ((p >> 4) & 15)), which
// keeps every pass's stores and loads free of bank conflicts. The forward
// transform is decimation in frequency and leaves the spectrum in the
// digit-reversed order of its last pass; every inverse transform is its
// adjoint, pass by pass in reverse, so it starts from the registers of that
// order and ends in natural order. The spectrum waits in shared memory, in
// the registers' order; each bin multiplies it by R_b (laid out by the
// wrapper in the same order, scaled by the inverse's 1/N, read through L1),
// runs the inverse and folds |y|^2 into a running max and argmax in
// registers (strict >, from -1, so the lowest bin wins a tie, as in the TPU
// kernel; the bin is a byte). The outputs go to device memory once a frame,
// coalesced. Inter-pass twiddles W_L^(m k) come from a table computed in
// float64 on the host that holds W_L^(e m) for e = 1, 2, 4, 8; the other
// powers are products of at most three of them. The twiddles inside a
// radix-16 butterfly are exact constants. No fast math. A thread gets at
// most 128 registers, so four 2048-point frames share an SM. Measured on
// the card and not kept: two or four frames a block (to share R_b's lines),
// the spectrum in registers, and a full 15-entry twiddle table; each was
// slower.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoints = 16;  // complex points a thread holds

// blocks an SM must hold: caps a thread at 128 registers
constexpr int min_blocks(int threads) { return threads >= 512 ? 1 : 512 / threads; }

__host__ __device__ constexpr int num_passes(int n) { return n == 8192 ? 4 : 3; }

__host__ __device__ constexpr int radix_of(int n, int p) {
  return p == 3 ? 2 : (n == 2048 && p == 2 ? 8 : 16);
}

// length of pass p's in-place sub-sequences
__host__ __device__ constexpr int span_of(int n, int p) {
  int l = n;
  for (int i = 0; i < p; ++i) l /= radix_of(n, i);
  return l;
}

// start of pass p's twiddle bases in the table: 4 * M of each earlier pass
// whose butterflies are M > 1 points apart
__host__ __device__ constexpr int tw_offset(int n, int p) {
  int off = 0;
  for (int i = 0; i < p; ++i) {
    const int m = span_of(n, i) / radix_of(n, i);
    if (m > 1) off += 4 * m;
  }
  return off;
}

__host__ __device__ constexpr int tw_len(int n) { return tw_offset(n, num_passes(n)); }

__host__ __device__ constexpr int bit_reverse(int k, int r) {
  int o = 0;
  for (int b = 1; b < r; b <<= 1) {
    o = (o << 1) | (k & 1);
    k >>= 1;
  }
  return o;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(w) * a
__device__ __forceinline__ float2 cmulc(float2 a, float2 w) {
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}

// cos and sin of 2 pi q / 16, q < 8
__device__ __forceinline__ float cos16(int q) {
  switch (q) {
    case 0: return 1.0f;
    case 1: return 0.923879532511286756f;
    case 2: return 0.707106781186547524f;
    case 3: return 0.382683432365089772f;
    case 4: return 0.0f;
    case 5: return -0.382683432365089772f;
    case 6: return -0.707106781186547524f;
    default: return -0.923879532511286756f;
  }
}

__device__ __forceinline__ float sin16(int q) {
  switch (q) {
    case 0: return 0.0f;
    case 1: return 0.382683432365089772f;
    case 2: return 0.707106781186547524f;
    case 3: return 0.923879532511286756f;
    case 4: return 1.0f;
    case 5: return 0.923879532511286756f;
    case 6: return 0.707106781186547524f;
    default: return 0.382683432365089772f;
  }
}

// v * exp(-+2 pi i q / 16): the forward transform's sign, or the inverse's
template <bool kInv>
__device__ __forceinline__ float2 rot16(float2 v, int q) {
  if (q == 0) return v;
  if (q == 4) return kInv ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
  const float c = cos16(q);
  const float s = kInv ? -sin16(q) : sin16(q);
  return make_float2(v.x * c + v.y * s, v.y * c - v.x * s);
}

// One radix-2 decimation-in-frequency stage of an in-register R-point DFT:
// butterflies of half-span H, then the stages of half-span H/2 .. 1.
template <int R, int H, bool kInv>
__device__ __forceinline__ void dft_stage(float2 (&x)[kPoints], int base) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int p = i % H;
    const int lo = base + (i / H) * 2 * H + p;
    const float2 a = x[lo];
    const float2 b = x[lo + H];
    x[lo] = cadd(a, b);
    x[lo + H] = rot16<kInv>(csub(a, b), p * (8 / H));
  }
  if constexpr (H > 1) dft_stage<R, H / 2, kInv>(x, base);
}

// In-register DFT of the R points x[base .. base + R), natural order in and
// out: radix-2 decimation-in-frequency stages, then the bit reversal as a
// renaming of registers. The stages are template recursion and every loop
// has a constant trip count, so every index is a compile-time constant and
// x stays in registers.
template <int R, bool kInv>
__device__ __forceinline__ void dft(float2 (&x)[kPoints], int base) {
  dft_stage<R, R / 2, kInv>(x, base);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int rk = bit_reverse(k, R);
    if (k < rk) {
      const float2 tmp = x[base + k];
      x[base + k] = x[base + rk];
      x[base + rk] = tmp;
    }
  }
}

// One pass: radix-R butterflies on sub-sequences of length L, points
// M = L / R apart. Forward: butterfly, then twiddle output k by W_L^(m k).
// Inverse (the adjoint): twiddle input r by conj(W_L^(m r)), then butterfly.
template <int R, int L, int T, bool kInv>
__device__ __forceinline__ void butterflies(float2 (&x)[kPoints],
                                            const float2* tb, int t) {
  constexpr int M = L / R;
  if constexpr (M > 1) {
    static_assert(R == kPoints, "a twiddled pass is radix 16");
    const int m = t % M;
    float2 w[kPoints];  // w[k] = W_L^(m k), k >= 1
    w[1] = tb[m];
    w[2] = tb[M + m];
    w[4] = tb[2 * M + m];
    w[8] = tb[3 * M + m];
    w[3] = cmul(w[1], w[2]);
    w[5] = cmul(w[4], w[1]);
    w[6] = cmul(w[4], w[2]);
    w[7] = cmul(w[4], w[3]);
#pragma unroll
    for (int k = 1; k < 8; ++k) w[8 + k] = cmul(w[8], w[k]);
    if constexpr (kInv) {
#pragma unroll
      for (int k = 1; k < kPoints; ++k) x[k] = cmulc(x[k], w[k]);
    }
    dft<R, kInv>(x, 0);
    if constexpr (!kInv) {
#pragma unroll
      for (int k = 1; k < kPoints; ++k) x[k] = cmul(x[k], w[k]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPoints / R; ++u) dft<R, kInv>(x, u * R);
  }
}

// Position in the in-place array of the point thread t holds in register
// j = u R + r: butterfly beta = t + T u, point r
// (ops/acquire_cuda.py::kernel_positions).
template <int R, int L, int T>
__device__ __forceinline__ int position(int t, int j) {
  constexpr int M = L / R;
  const int beta = t + T * (j / R);
  return (beta / M) * L + (j % R) * M + beta % M;
}

__device__ __forceinline__ int swizzle(int p) { return p ^ ((p >> 4) & 15); }

// Registers at the positions of one pass -> registers at the next pass's.
template <int Rw, int Lw, int Rr, int Lr, int T>
__device__ __forceinline__ void exchange(float2 (&x)[kPoints], float2* buf, int t) {
#pragma unroll
  for (int j = 0; j < kPoints; ++j) buf[swizzle(position<Rw, Lw, T>(t, j))] = x[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPoints; ++j) x[j] = buf[swizzle(position<Rr, Lr, T>(t, j))];
}

// Passes kP.. of the forward transform. Exchanges alternate between the
// frame's two buffers, so one barrier an exchange suffices.
template <int kN, int kP>
__device__ __forceinline__ void forward(float2 (&x)[kPoints], float2* bufs,
                                        int& phase, const float2* tws, int t) {
  constexpr int T = kN / kPoints;
  constexpr int R = radix_of(kN, kP);
  constexpr int L = span_of(kN, kP);
  butterflies<R, L, T, false>(x, tws + tw_offset(kN, kP), t);
  if constexpr (kP + 1 < num_passes(kN)) {
    exchange<R, L, radix_of(kN, kP + 1), span_of(kN, kP + 1), T>(
        x, bufs + (phase & 1) * kN, t);
    ++phase;
    forward<kN, kP + 1>(x, bufs, phase, tws, t);
  }
}

// Passes kP, kP - 1, .. 0 of the inverse transform.
template <int kN, int kP>
__device__ __forceinline__ void inverse(float2 (&x)[kPoints], float2* bufs,
                                        int& phase, const float2* tws, int t) {
  constexpr int T = kN / kPoints;
  constexpr int R = radix_of(kN, kP);
  constexpr int L = span_of(kN, kP);
  butterflies<R, L, T, true>(x, tws + tw_offset(kN, kP), t);
  if constexpr (kP > 0) {
    exchange<R, L, radix_of(kN, kP - 1), span_of(kN, kP - 1), T>(
        x, bufs + (phase & 1) * kN, t);
    ++phase;
    inverse<kN, kP - 1>(x, bufs, phase, tws, t);
  }
}

template <int kN>
__global__ void __launch_bounds__(kN / kPoints, min_blocks(kN / kPoints))
correlate_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ br, const float* __restrict__ bi,
                 const float2* __restrict__ rf, const float2* __restrict__ tw,
                 float* __restrict__ out_pow, int* __restrict__ out_bin, int s,
                 int nb) {
  constexpr int T = kN / kPoints;
  constexpr int kTw = tw_len(kN);
  extern __shared__ float2 smem[];
  float2* tws = smem;             // twiddle bases
  float2* bufs = smem + kTw;      // two exchange buffers
  float2* spec = bufs + 2 * kN;   // the spectrum, spec[j * T + t]
  const int t = threadIdx.x;
  const int64_t f = blockIdx.x;
  for (int k = t; k < kTw; k += T) tws[k] = tw[k];
  float2 x[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int n = j * T + t;  // pass 0's positions: natural order
    x[j] = n < s ? make_float2(ar[f * s + n], ai[f * s + n])
                 : make_float2(br[f * s + n - s], bi[f * s + n - s]);
  }
  __syncthreads();

  int phase = 0;
  forward<kN, 0>(x, bufs, phase, tws, t);
#pragma unroll
  for (int j = 0; j < kPoints; ++j) spec[j * T + t] = x[j];

  float pmax[kPoints];
  uint32_t pbin[kPoints / 4];  // one byte a point
#pragma unroll
  for (int j = 0; j < kPoints; ++j) pmax[j] = -1.0f;
#pragma unroll
  for (int j = 0; j < kPoints / 4; ++j) pbin[j] = 0;
  for (int b = 0; b < nb; ++b) {
    const float2* r = rf + static_cast<int64_t>(b) * kN + t;
#pragma unroll
    for (int j = 0; j < kPoints; ++j) x[j] = cmul(spec[j * T + t], __ldg(r + j * T));
    inverse<kN, num_passes(kN) - 1>(x, bufs, phase, tws, t);
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      // R_b carries the inverse's 1/N, so this is |y|^2 / N^2
      const float p = x[j].x * x[j].x + x[j].y * x[j].y;
      if (p > pmax[j]) {
        const int sh = 8 * (j & 3);
        pmax[j] = p;
        pbin[j >> 2] = (pbin[j >> 2] & ~(0xffu << sh)) | (static_cast<uint32_t>(b) << sh);
      }
    }
  }
  float* op = out_pow + f * kN;
  int* ob = out_bin + f * kN;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    op[j * T + t] = pmax[j];
    ob[j * T + t] = static_cast<int>((pbin[j >> 2] >> (8 * (j & 3))) & 0xffu);
  }
}

template <int kN>
int launch(const void* ar, const void* ai, const void* br, const void* bi,
           const void* rf, const void* tw, void* out_pow, void* out_bin,
           int fpad, int s, int nb, cudaStream_t stream) {
  const size_t smem = sizeof(float2) * (tw_len(kN) + 3 * kN);
  cudaError_t err = cudaFuncSetAttribute(
      correlate_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  correlate_kernel<kN><<<fpad, kN / kPoints, smem, stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(ai),
      static_cast<const float*>(br), static_cast<const float*>(bi),
      static_cast<const float2*>(rf), static_cast<const float2*>(tw),
      static_cast<float*>(out_pow), static_cast<int*>(out_bin), s, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// log2n in {11, 12, 13}: N = 2048, 4096 or 8192; 1 <= nb <= 256 (the wrapper
// checks both). rf: the replica spectra times 1/N, in the registers' order.
extern "C" int pm_correlate(const void* ar, const void* ai, const void* br,
                            const void* bi, const void* rf, const void* tw,
                            void* out_pow, void* out_bin, int fpad, int s,
                            int nb, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 11:
      return launch<2048>(ar, ai, br, bi, rf, tw, out_pow, out_bin, fpad, s, nb, st);
    case 12:
      return launch<4096>(ar, ai, br, bi, rf, tw, out_pow, out_bin, fpad, s, nb, st);
    case 13:
      return launch<8192>(ar, ai, br, bi, rf, tw, out_pow, out_bin, fpad, s, nb, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
