// K5's warp plan: one warp decodes one codeword, lane l owning variables
// l + 32k (k < kVarsPerLane) and checks l + 32k (k < kChecksPerLane). A
// lane keeps its index lists and its checks' outgoing messages in registers
// for all iterations; each phase publishes what the other phase reads to a
// per-warp array in shared memory: the variable totals `tot` at their ids,
// the check messages `c2v` at their flat edge ids (c * dmax + j).
//
// Padding reads and writes go to slots past the code's: a padding edge of a
// variable reads kZeroMsg (always 0.0, as the plain version's padding edges
// read one extra zero message); a padding slot of a check reads kInfTotal
// (always +inf, so its extrinsic value is +inf: sign +1 and magnitude inf,
// the scan decoder's mask) and writes its message to kTrashMsg; a variable
// or check past the code writes to kTrashTotal or kTrashMsg. So neither
// phase tests a mask, and both keep the plain version's arithmetic order:
// kernel and plain version agree bit for bit.
//
// Included by ldpc.cu (the kernel) and probe/chain.cu (the chain-latency
// probe), so both run the same iteration body. ops/ldpc_cuda.py::warp_plan
// is the same plan in numpy; the CPU tests run BP along it, and the wrapper
// checks these limits before any launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pm_ldpc {

constexpr int kWarp = 32;
constexpr int kVarsPerLane = 4;    // n <= 128
constexpr int kChecksPerLane = 3;  // m <= 96
constexpr int kVarDeg = 3;         // edges a variable
constexpr int kMaxDeg = 5;         // slots a check (the table's dmax)
constexpr int kZeroMsg = kWarp * kChecksPerLane * kMaxDeg;
constexpr int kTrashMsg = kZeroMsg + 1;
constexpr int kC2vFloats = kTrashMsg + 1;
constexpr int kInfTotal = kWarp * kVarsPerLane;
constexpr int kTrashTotal = kInfTotal + 1;
constexpr int kTotFloats = kTrashTotal + 1;

struct Lane {
  int var_in[kVarsPerLane][kVarDeg];     // c2v slot each edge reads
  int var_out[kVarsPerLane];             // tot slot each total goes to
  int chk_in[kChecksPerLane][kMaxDeg];   // tot slot each check slot reads
  int chk_out[kChecksPerLane][kMaxDeg];  // c2v slot each message goes to
  float c2v[kChecksPerLane][kMaxDeg];    // outgoing messages of my checks
  float llr[kVarsPerLane];
  float total[kVarsPerLane];
};

// Lane state from the wrapper's int32 tables (ops/ldpc.py::edge_tables);
// `llrs` is the codeword's row. Publishes zero messages, the zero slot and
// the +inf total: the first variable phase then sums zeros, as the plain
// version does.
__device__ __forceinline__ void load_lane(Lane& s, int lane,
                                          const float* __restrict__ llrs,
                                          const int* __restrict__ chk_vars,
                                          const int* __restrict__ var_edges,
                                          int m, int dmax, int n, int vdeg,
                                          float* c2v_sh, float* tot_sh) {
#pragma unroll
  for (int k = 0; k < kVarsPerLane; ++k) {
    const int v = lane + kWarp * k;
#pragma unroll
    for (int j = 0; j < kVarDeg; ++j) {
      const int e = (v < n && j < vdeg) ? var_edges[v * vdeg + j] : -1;
      s.var_in[k][j] = e >= 0 ? e : kZeroMsg;
    }
    s.var_out[k] = v < n ? v : kTrashTotal;
    s.llr[k] = v < n ? llrs[v] : 0.0f;
    s.total[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kChecksPerLane; ++k) {
    const int c = lane + kWarp * k;
#pragma unroll
    for (int j = 0; j < kMaxDeg; ++j) {
      const int v = (c < m && j < dmax) ? chk_vars[c * dmax + j] : -1;
      s.chk_in[k][j] = v >= 0 ? v : kInfTotal;
      s.chk_out[k][j] = v >= 0 ? c * dmax + j : kTrashMsg;
      s.c2v[k][j] = 0.0f;
      c2v_sh[s.chk_out[k][j]] = 0.0f;
    }
  }
  if (lane == 0) {
    c2v_sh[kZeroMsg] = 0.0f;
    tot_sh[kInfTotal] = INFINITY;
  }
}

// Both phases issue all their shared-memory loads first, then compute, then
// publish: no load waits behind another's use or behind a store it might
// alias, and the lane's independent variables and checks overlap.

// Variable phase: each variable's incoming messages summed from 0.0 in the
// edge table's order, then the channel LLR; the totals are published for
// the check phase.
__device__ __forceinline__ void variable_phase(Lane& s, const float* c2v_sh,
                                               float* tot_sh) {
  float in[kVarsPerLane][kVarDeg];
#pragma unroll
  for (int k = 0; k < kVarsPerLane; ++k)
#pragma unroll
    for (int j = 0; j < kVarDeg; ++j) in[k][j] = c2v_sh[s.var_in[k][j]];
#pragma unroll
  for (int k = 0; k < kVarsPerLane; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kVarDeg; ++j) acc = __fadd_rn(acc, in[k][j]);
    s.total[k] = __fadd_rn(s.llr[k], acc);
  }
#pragma unroll
  for (int k = 0; k < kVarsPerLane; ++k) tot_sh[s.var_out[k]] = s.total[k];
}

// Check phase: normalised min-sum with the scan decoder's first-minimum
// rule (m2 is the least magnitude once the first least one is taken out)
// and its min(., 1e30) clamp; the new messages stay in registers and are
// published for the next variable phase.
__device__ __forceinline__ void check_phase(Lane& s, const float* tot_sh,
                                            float* c2v_sh, float alpha) {
  float in[kChecksPerLane][kMaxDeg];
#pragma unroll
  for (int k = 0; k < kChecksPerLane; ++k)
#pragma unroll
    for (int j = 0; j < kMaxDeg; ++j) in[k][j] = tot_sh[s.chk_in[k][j]];
#pragma unroll
  for (int k = 0; k < kChecksPerLane; ++k) {
    float sg[kMaxDeg], mg[kMaxDeg];
    float tot_sgn = 1.0f, m1 = INFINITY, m2 = INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxDeg; ++j) {
      const float x = __fsub_rn(in[k][j], s.c2v[k][j]);
      sg[j] = x >= 0.0f ? 1.0f : -1.0f;
      mg[j] = fabsf(x);
      tot_sgn *= sg[j];
      m2 = fminf(m2, fmaxf(m1, mg[j]));
      m1 = fminf(m1, mg[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxDeg; ++j) {
      const float mag = fminf(mg[j] == m1 ? m2 : m1, 1e30f);
      s.c2v[k][j] = __fmul_rn(__fmul_rn(alpha, tot_sgn * sg[j]), mag);
    }
  }
#pragma unroll
  for (int k = 0; k < kChecksPerLane; ++k)
#pragma unroll
    for (int j = 0; j < kMaxDeg; ++j) c2v_sh[s.chk_out[k][j]] = s.c2v[k][j];
}

// One flooding iteration after the variable phase that opened it: the
// check phase, then the next variable phase. A warp-wide barrier separates
// each phase's publishing from the other phase's reads.
__device__ __forceinline__ void iteration(Lane& s, float* c2v_sh,
                                          float* tot_sh, float alpha) {
  __syncwarp();
  check_phase(s, tot_sh, c2v_sh, alpha);
  __syncwarp();
  variable_phase(s, c2v_sh, tot_sh);
}

}  // namespace pm_ldpc
