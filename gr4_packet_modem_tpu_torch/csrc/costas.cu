// K4 Costas loop: the exact per-packet carrier-recovery recursion over the
// receiver's positional schedule. For each symbol: rotate by -phase, take the
// pilot error for global symbols below 64 and the QPSK decision error after,
// update freq += K2*e and phase += K1*e + freq, wrap phase to [-pi, pi).
//
// Replaces gr4_packet_modem_tpu/ops/costas_pallas.py::costas_track_pallas
// (kernel _make_kernel). The TPU kernel advanced 1024 packets per step in one
// [8, 128] vector tile and carried the state across symbol blocks in scratch
// memory; here each packet is one thread and the whole recursion runs in its
// registers.
//
// Bound: latency of the sequential dependency chain (cosf/sinf and about 15
// dependent operations per symbol); the arithmetic and the 16 bytes moved per
// symbol are small. Design: one thread per packet, symbols in sequence, and
// the batch on the fast axis: the symbols arrive as an [S, B] complex plane so
// the 32 threads of a warp load and store 32 neighbouring packets' symbol s
// in one coalesced access. The gains are compile-time constants
// (PM_COSTAS_K*, from costas_coefficients via the build). Products and sums
// use explicit round-to-nearest intrinsics so nvcc does not contract them into
// fused multiply-adds, and cosf/sinf are the accurate versions (no fast
// math): the feedback loop would amplify any extra rounding difference from
// the reference.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PM_COSTAS_K1A
#error "PM_COSTAS_K1A..K2C must be defined by the build (ops/_build.py)"
#endif

namespace {

constexpr int kSyncLen = 64;   // PILOT segment (wiped-off syncword)
constexpr int kHdrEnd = 192;   // syncword + 128 header symbols
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 2.0f * kPi;

__global__ void costas_kernel(const float2* __restrict__ sym,
                              float2* __restrict__ out,
                              const float* __restrict__ ph0,
                              const float* __restrict__ fr0,
                              float* __restrict__ ph_end,
                              float* __restrict__ fr_end, int b, int s,
                              int offset) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= b) return;
  float ph = ph0[p];
  float fr = fr0[p];
  for (int i = 0; i < s; ++i) {
    const int g = i + offset;
    const bool pilot = g < kSyncLen;
    const float k1 = pilot ? PM_COSTAS_K1A : (g < kHdrEnd ? PM_COSTAS_K1B : PM_COSTAS_K1C);
    const float k2 = pilot ? PM_COSTAS_K2A : (g < kHdrEnd ? PM_COSTAS_K2B : PM_COSTAS_K2C);
    const int64_t at = static_cast<int64_t>(i) * b + p;
    const float2 x = sym[at];
    const float c = cosf(ph);
    const float sn = sinf(ph);
    const float zr = __fadd_rn(__fmul_rn(x.x, c), __fmul_rn(x.y, sn));
    const float zi = __fsub_rn(__fmul_rn(x.y, c), __fmul_rn(x.x, sn));
    const float e_qpsk = __fadd_rn(zr > 0.0f ? zi : -zi, zi > 0.0f ? -zr : zr);
    const float e = pilot ? zi : e_qpsk;
    fr = __fadd_rn(fr, __fmul_rn(k2, e));
    ph = __fadd_rn(__fadd_rn(ph, __fmul_rn(k1, e)), fr);
    if (ph >= kPi) ph = __fsub_rn(ph, kTwoPi);
    if (ph < -kPi) ph = __fadd_rn(ph, kTwoPi);
    out[at] = make_float2(zr, zi);
  }
  ph_end[p] = ph;
  fr_end[p] = fr;
}

}  // namespace

extern "C" int pm_costas_track(const void* sym, void* out, const void* ph0,
                               const void* fr0, void* ph_end, void* fr_end,
                               int b, int s, int offset, void* stream) {
  // one warp per block spreads B = 1536 packets over 48 SMs instead of 12
  constexpr int kThreads = 32;
  costas_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(sym), static_cast<float2*>(out),
      static_cast<const float*>(ph0), static_cast<const float*>(fr0),
      static_cast<float*>(ph_end), static_cast<float*>(fr_end), b, s, offset);
  return static_cast<int>(cudaGetLastError());
}
