// K5 LDPC belief propagation: flooding normalised min-sum on the (128,32)
// header code (96 checks of degree 3 to 5, 384 edges), returning the
// per-variable totals after the last iteration. The hard decision and the
// syndrome check stay in PyTorch (ops/ldpc.py::finish).
//
// Replaces gr4_packet_modem_tpu/ops/ldpc_pallas.py::ldpc_totals_pallas
// (kernel _make_kernel). The TPU kernel gathered and scattered messages with
// 0/1 selection matmuls on the matrix unit; here they are index lookups in
// tables built from the parity-check matrix (ops/ldpc.py::edge_tables).
//
// Bound: latency. A codeword's 25 iterations are a chain of dependent
// phases over only 384 edges (about 8 operations each), and the batch reads
// and writes 1536 x 128 x 4 bytes once. Design: one warp per codeword, one
// codeword a block (measured faster than 4 or 8 a block), no block-wide
// barrier. The code fits one warp (128 variables of degree 3, 96 checks: 4
// and 3 a lane), so each lane keeps its index lists and its checks'
// messages in registers for all iterations, with the slot loops unrolled
// over compile-time maxima and padding slots pointed at inert shared slots
// instead of masked (ldpc_warp.cuh); only the values one phase publishes for
// the other go through shared memory, with no index loads on the way, all
// of a phase's loads issued before its arithmetic. Both phases follow the
// plain version's arithmetic order exactly, so kernel and plain version
// agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ldpc_warp.cuh"

namespace {

__global__ void __launch_bounds__(pm_ldpc::kWarp)
    ldpc_kernel(const float* __restrict__ llrs, float* __restrict__ totals,
                const int* __restrict__ chk_vars,
                const int* __restrict__ var_edges, int m, int dmax, int n,
                int vdeg, int iters, float alpha) {
  using namespace pm_ldpc;
  __shared__ float c2v_sh[kC2vFloats];
  __shared__ float tot_sh[kTotFloats];
  const int lane = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  Lane s;
  load_lane(s, lane, llrs + row, chk_vars, var_edges, m, dmax, n, vdeg, c2v_sh,
            tot_sh);
  __syncwarp();
  variable_phase(s, c2v_sh, tot_sh);
  for (int it = 0; it < iters; ++it) iteration(s, c2v_sh, tot_sh, alpha);
#pragma unroll
  for (int k = 0; k < kVarsPerLane; ++k) {
    const int v = lane + kWarp * k;
    if (v < n) totals[row + v] = s.total[k];
  }
}

}  // namespace

extern "C" int pm_ldpc_totals(const void* llrs, void* totals,
                              const void* chk_vars, const void* var_edges,
                              int b, int m, int dmax, int n, int vdeg,
                              int iters, float alpha, void* stream) {
  using namespace pm_ldpc;
  // the wrapper checks the same limits (ops/ldpc_cuda.py::check_limits)
  if (n > kWarp * kVarsPerLane || m > kWarp * kChecksPerLane ||
      vdeg > kVarDeg || dmax > kMaxDeg)
    return static_cast<int>(cudaErrorInvalidValue);
  ldpc_kernel<<<b, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llrs), static_cast<float*>(totals),
      static_cast<const int*>(chk_vars), static_cast<const int*>(var_edges), m,
      dmax, n, vdeg, iters, alpha);
  return static_cast<int>(cudaGetLastError());
}
