// One step of K4's Costas recursion, for one packet, on values in
// registers. Included by costas.cu (the kernel) and probe/chain.cu (the
// chain-latency probe), so both run the same step.
//
// For global symbol g: rotate x by -phase, take the pilot error below
// symbol 64 and the QPSK decision error after, update freq += K2*e and
// phase += K1*e + freq, wrap phase to [-pi, pi). The gains are compile-time
// constants (PM_COSTAS_K*, from costas_coefficients via ops/_build.py).
// Products and sums use explicit round-to-nearest intrinsics so nvcc does
// not contract them into fused multiply-adds, and cosf/sinf are the
// accurate versions (no fast math): the feedback loop would amplify any
// rounding difference from the plain version.
#pragma once

#include <cuda_runtime.h>

#ifndef PM_COSTAS_K1A
#error "PM_COSTAS_K1A..K2C must be defined by the build (ops/_build.py)"
#endif

namespace pm_costas {

constexpr int kSyncLen = 64;  // PILOT segment (wiped-off syncword)
constexpr int kHdrEnd = 192;  // syncword + 128 header symbols
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 2.0f * kPi;

__device__ __forceinline__ float2 step(float2 x, int g, float& ph, float& fr) {
  const bool pilot = g < kSyncLen;
  const float k1 = pilot ? PM_COSTAS_K1A : (g < kHdrEnd ? PM_COSTAS_K1B : PM_COSTAS_K1C);
  const float k2 = pilot ? PM_COSTAS_K2A : (g < kHdrEnd ? PM_COSTAS_K2B : PM_COSTAS_K2C);
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
  return make_float2(zr, zi);
}

}  // namespace pm_costas
