// Chain-latency probes of K4 and K5: one warp runs the kernels' own step
// bodies (costas_step.cuh, ldpc_warp.cuh) on values held in registers, with
// no device-memory traffic inside the timed loop, and reads clock64()
// around it. Cycles per step times the steps of a call is the least time a
// call can take whatever its loads do: the chain floor. Beside them, an
// empty kernel: its device time is the least that any launch takes, the
// launch floor. Built on its own, outside the port's library
// (ops/_build.py::build_single), by chip_smoke.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../costas_step.cuh"
#include "../ldpc_warp.cuh"

namespace {

// K4: `steps` symbols from global symbol `offset` on, on one symbol held in
// registers (a QPSK point near the loop's lock).
__global__ void costas_chain(long long* cycles, float* sink, int steps,
                             int offset) {
  const int lane = threadIdx.x;
  const float2 x = make_float2(0.70f + 0.001f * lane, 0.71f - 0.001f * lane);
  float ph = 0.01f * lane, fr = 0.0f, acc = 0.0f;
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    const float2 z = pm_costas::step(x, offset + i, ph, fr);
    acc += z.x;
  }
  const long long t1 = clock64();
  cycles[lane] = t1 - t0;
  sink[lane] = ph + fr + acc;
}

// K5: `iters` iterations (check phase, then variable phase) of one
// codeword, after the same set-up and first variable phase as the kernel.
__global__ void ldpc_chain(long long* cycles, float* sink, const float* llrs,
                           const int* chk_vars, const int* var_edges, int m,
                           int dmax, int n, int vdeg, int iters, float alpha) {
  using namespace pm_ldpc;
  __shared__ float c2v_sh[kC2vFloats];
  __shared__ float tot_sh[kTotFloats];
  const int lane = threadIdx.x;
  Lane s;
  load_lane(s, lane, llrs, chk_vars, var_edges, m, dmax, n, vdeg, c2v_sh,
            tot_sh);
  __syncwarp();
  variable_phase(s, c2v_sh, tot_sh);
  __syncwarp();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) iteration(s, c2v_sh, tot_sh, alpha);
  const long long t1 = clock64();
  cycles[lane] = t1 - t0;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kVarsPerLane; ++k) acc += s.total[k];
  sink[lane] = acc;
}

// The launch floor: one warp that does nothing.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int pm_costas_chain(void* cycles, void* sink, int steps, int offset,
                               void* stream) {
  costas_chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(cycles), static_cast<float*>(sink), steps,
      offset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pm_ldpc_chain(void* cycles, void* sink, const void* llrs,
                             const void* chk_vars, const void* var_edges, int m,
                             int dmax, int n, int vdeg, int iters, float alpha,
                             void* stream) {
  ldpc_chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(cycles), static_cast<float*>(sink),
      static_cast<const float*>(llrs), static_cast<const int*>(chk_vars),
      static_cast<const int*>(var_edges), m, dmax, n, vdeg, iters, alpha);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pm_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
