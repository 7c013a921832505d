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
//
// The fused extraction (kFromBank, entry pm_extract_symbols): the receiver's
// whole symbol extraction in one launch, in place of K2's fetch, the
// derotation's elementwise passes, K3 and the scaling, chunk by chunk, and the
// concatenation after them. Each row d extracts num_syms symbols from symbol
// sym_offset, in chunks of `chunk` symbols; chunk c reads the region of
// R = sps (chunk - 1) + K samples at
//   start_c = clamp(n_base[d] + sps (sym_offset + c chunk) - (K - 1), 0, row_len - R)
// of its channel's row of the complex64 bank, read as it lies. The grid is
// (row, chunk, block within the chunk), row-major, so the rows of a channel,
// whose slots overlap in the bank, run together and share the L2. A block
// stages its window of the region as K3 does, derotating each sample once as
// it lands: n = start_c + j - n0[d] (j the sample's place in the region),
// ph = -freq[d] * float(n), and with c, s = cos ph, sin ph (sincosf, no fast
// math) dr = re c - im s, di = re s + im c, each product and sum rounded on
// its own, so that these are the numbers of the unfused passes. The taps are
// the row's arm of the receiver's table, reversed as they are staged; the
// sum is K3's; each output is scaled by amp[d] and written, interleaved, into
// its place in the one [D, num_syms] complex64 output. A block stages only
// the window its written outputs need (the last blocks of a chunk and of a
// row write fewer than kQ * blockDim.x), and a block with none returns.
// The plane entry (pm_matched_filter) is off the receive path: with K2 and
// the derotation in PyTorch it is the unfused chain that the fused
// extraction equals bit for bit (tests/test_torch_cuda.py, chip_smoke.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 9;          // consecutive outputs a thread computes (odd)
constexpr int kThreads = 128;  // most threads a block

__host__ __device__ inline int phase_row(int cs, int kq) {
  const int pl = cs + kq - 1;  // a phase's values a chunk needs
  return ((pl + 31) & ~31) + 8;
}

// the fused extraction's rows (kFromBank); all [D] but x, taps and out
struct Bank {
  const float2* x;        // the complex64 bank, flattened [C * row_len]
  const int64_t* n_base;  // sample of each row's symbol 0, channel-local
  const int64_t* chan;    // each row's channel, or null (one capture)
  const int64_t* n0;      // the derotation's reference sample
  const int64_t* arm;     // polyphase arm: a row of the taps table
  const float* freq;      // rad/sample
  const float* amp;       // amplitude scale
  float2* out;            // [D, num_syms]
  long long row_len;      // samples a channel
  int sym_offset;         // first symbol extracted
  int chunk;              // symbols a chunk (the clamp's unit)
  int nchunks;
  int blocks_per_chunk;
};

// one bank sample derotated by exp(-i freq n), as the unfused passes do it
__device__ __forceinline__ void derotate(float2 v, float nf, long long n, float* dr, float* di) {
  const float ph = __fmul_rn(nf, __ll2float_rn(n));
  float s, c;
  sincosf(ph, &s, &c);
  *dr = __fsub_rn(__fmul_rn(v.x, c), __fmul_rn(v.y, s));
  *di = __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, c));
}

// kSps, kKQ: sps and ceil(K / sps) as constants, or 0 to read them at run
// time. kFromBank: the fused extraction (taps: the arm table [arms, K]);
// else K3 on planes (taps: [D, K], time-reversed).
template <int kSps, int kKQ, bool kFromBank>
__global__ void __launch_bounds__(kThreads)
matched_filter_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                      const float* __restrict__ taps, float* __restrict__ outr,
                      float* __restrict__ outi, int region_len, int ntaps,
                      int sps_rt, int num_syms, int chunks, Bank bank) {
  extern __shared__ float smem[];
  const int sps = kSps > 0 ? kSps : sps_rt;
  const int kq = kKQ > 0 ? kKQ : (ntaps + sps - 1) / sps;
  const int nt = blockDim.x;
  const int cs = nt * kQ;
  const int plp = phase_row(cs, kq);
  float* tq = smem;
  float* wr = smem + kq * sps;
  float* wi = wr + sps * plp;

  int d, c = 0, s0, valid;
  if constexpr (kFromBank) {
    const int rest = blockIdx.x / bank.blocks_per_chunk;
    d = rest / bank.nchunks;
    c = rest % bank.nchunks;
    s0 = (blockIdx.x % bank.blocks_per_chunk) * cs;
    valid = min(cs, min(bank.chunk, num_syms - c * bank.chunk) - s0);
    if (valid <= 0) return;  // past the row's last symbol: the whole block
    const float* arm_row = taps + bank.arm[d] * ntaps;
    for (int k = threadIdx.x; k < kq * sps; k += nt) {
      tq[k] = k < ntaps ? arm_row[ntaps - 1 - k] : 0.0f;
    }
  } else {
    d = blockIdx.x / chunks;
    s0 = (blockIdx.x % chunks) * cs;
    valid = min(cs, num_syms - s0);
    for (int k = threadIdx.x; k < kq * sps; k += nt) {
      tq[k] = k < ntaps ? taps[static_cast<int64_t>(d) * ntaps + k] : 0.0f;
    }
  }
  const int64_t base = static_cast<int64_t>(sps) * s0;
  if constexpr (kFromBank) {
    long long st = bank.n_base[d] +
                   static_cast<long long>(sps) * (bank.sym_offset + static_cast<long long>(c) * bank.chunk) -
                   (ntaps - 1);
    st = st < 0 ? 0 : min(st, bank.row_len - region_len);
    const float2* src = bank.x + (bank.chan ? bank.chan[d] * bank.row_len : 0LL) + st + base;
    const long long n = st + base - bank.n0[d];  // the window's first sample, from n0
    const float nf = -bank.freq[d];
    const int64_t have = region_len - base;  // window samples inside the region
    const int syms = valid + kq - 1;         // the window's symbols the outputs read
    if (kSps == 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      // one symbol's four samples as two float4 (the window is 16-byte aligned)
      const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 2
      for (int m = threadIdx.x; m < syms; m += nt) {
        float2 v[4];
        if (4 * m + 4 <= have) {
          const float4 a = src4[2 * m], b = src4[2 * m + 1];
          v[0] = make_float2(a.x, a.y); v[1] = make_float2(a.z, a.w);
          v[2] = make_float2(b.x, b.y); v[3] = make_float2(b.z, b.w);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p) v[p] = 4 * m + p < have ? src[4 * m + p] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) derotate(v[p], nf, n + 4 * m + p, &wr[p * plp + m], &wi[p * plp + m]);
      }
    } else {
      const int win = sps * syms;
#pragma unroll 4
      for (int i = threadIdx.x; i < win; i += nt) {
        const float2 v = i < have ? src[i] : make_float2(0.f, 0.f);
        const int a = (i % sps) * plp + i / sps;
        derotate(v, nf, n + i, &wr[a], &wi[a]);
      }
    }
  } else {
    const float* zrd = zr + static_cast<int64_t>(d) * region_len;
    const float* zid = zi + static_cast<int64_t>(d) * region_len;
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
  if constexpr (kFromBank) {
    float2* o = bank.out + static_cast<int64_t>(d) * num_syms + static_cast<int64_t>(c) * bank.chunk + s0;
    const float a = bank.amp[d];
    for (int k = threadIdx.x; k < valid; k += nt) {
      o[k] = make_float2(__fmul_rn(wr[k], a), __fmul_rn(wi[k], a));
    }
  } else {
    const int64_t o = static_cast<int64_t>(d) * num_syms + s0;
    for (int k = threadIdx.x; k < valid; k += nt) {
      outr[o + k] = wr[k];
      outi[o + k] = wi[k];
    }
  }
}

// threads a block for blocks of `syms` outputs: enough for them in warps, at
// most kThreads
inline int block_threads(int syms) {
  const int want = (syms + kQ - 1) / kQ;
  return want >= kThreads ? kThreads : ((want + 31) / 32) * 32;
}

template <int kSps, int kKQ, bool kFromBank>
int launch(const void* zr, const void* zi, const void* taps, void* outr, void* outi,
           int region_len, int ntaps, int sps, int num_syms, int blocks, int chunks,
           int nt, const Bank& bank, cudaStream_t stream) {
  const int kq = (ntaps + sps - 1) / sps;
  const int cs = nt * kQ;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kq) * sps +
                                       2 * static_cast<size_t>(sps) * phase_row(cs, kq));
  cudaError_t err = cudaFuncSetAttribute(matched_filter_kernel<kSps, kKQ, kFromBank>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  matched_filter_kernel<kSps, kKQ, kFromBank><<<blocks, nt, smem, stream>>>(
      static_cast<const float*>(zr), static_cast<const float*>(zi),
      static_cast<const float*>(taps), static_cast<float*>(outr),
      static_cast<float*>(outi), region_len, ntaps, sps, num_syms, chunks, bank);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pm_matched_filter(const void* zr, const void* zi,
                                 const void* taps, void* outr, void* outi,
                                 int region_len, int ntaps, int sps,
                                 int num_syms, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = block_threads(num_syms);
  const int chunks = (num_syms + nt * kQ - 1) / (nt * kQ);
  if (static_cast<int64_t>(chunks) * d > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Bank none{};
  if (sps == 4 && (ntaps + 3) / 4 == 11) {
    return launch<4, 11, false>(zr, zi, taps, outr, outi, region_len, ntaps, sps, num_syms,
                                chunks * d, chunks, nt, none, st);
  }
  return launch<0, 0, false>(zr, zi, taps, outr, outi, region_len, ntaps, sps, num_syms,
                             chunks * d, chunks, nt, none, st);
}

// The fused extraction: out [D, num_syms] complex64 from the flattened bank
// x (row_len samples a channel; chan null for one capture), arm_taps the
// receiver's [arms, ntaps] table.
extern "C" int pm_extract_symbols(const void* x, const void* n_base, const void* chan,
                                  const void* n0, const void* arm, const void* arm_taps,
                                  const void* freq, const void* amp, void* out,
                                  long long row_len, int ntaps, int sps, int sym_offset,
                                  int num_syms, int chunk, int d, void* stream) {
  const int region_len = sps * (chunk - 1) + ntaps;
  if (chunk < 1 || num_syms < 1 || region_len > row_len) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = block_threads(chunk);
  const int per_chunk = (chunk + nt * kQ - 1) / (nt * kQ);
  const int nchunks = (num_syms + chunk - 1) / chunk;
  const int64_t blocks = static_cast<int64_t>(d) * nchunks * per_chunk;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Bank bank{static_cast<const float2*>(x), static_cast<const int64_t*>(n_base),
                  static_cast<const int64_t*>(chan), static_cast<const int64_t*>(n0),
                  static_cast<const int64_t*>(arm), static_cast<const float*>(freq),
                  static_cast<const float*>(amp), static_cast<float2*>(out),
                  row_len, sym_offset, chunk, nchunks, per_chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sps == 4 && (ntaps + 3) / 4 == 11) {
    return launch<4, 11, true>(nullptr, nullptr, arm_taps, nullptr, nullptr, region_len, ntaps, sps,
                               num_syms, static_cast<int>(blocks), 0, nt, bank, st);
  }
  return launch<0, 0, true>(nullptr, nullptr, arm_taps, nullptr, nullptr, region_len, ntaps, sps,
                            num_syms, static_cast<int>(blocks), 0, nt, bank, st);
}
