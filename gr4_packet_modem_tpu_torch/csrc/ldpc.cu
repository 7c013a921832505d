// K5 LDPC belief propagation: flooding normalised min-sum on the (128,32)
// header code (96 checks of degree <= 5), returning the per-variable totals
// after the last iteration. The hard decision and the syndrome check stay in
// PyTorch (ops/ldpc.py::finish).
//
// Replaces gr4_packet_modem_tpu/ops/ldpc_pallas.py::ldpc_totals_pallas
// (kernel _make_kernel). The TPU kernel gathered and scattered messages with
// 0/1 selection matmuls on the matrix unit; here they are index lookups in
// tables built from the parity-check matrix (ops/ldpc.py::edge_tables).
//
// Bound: latency. A codeword's 25 iterations are a chain of dependent steps
// over only 384 edges, and the whole batch reads 1536 x 128 x 4 bytes once.
// Design: one block per codeword with one thread per variable. Messages and
// totals stay in shared memory for all iterations; a check's five incoming
// messages live in one thread's registers for its update. Both phases follow
// the plain version's arithmetic order exactly (variable sums over the edge
// table in its order, then the min-sum update with the scan decoder's
// masking and its min(., 1e30) clamp), so kernel and plain version agree bit
// for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDeg = 8;  // largest check degree the register arrays hold

__global__ void ldpc_kernel(const float* __restrict__ llrs,
                            float* __restrict__ totals,
                            const int* __restrict__ chk_vars,
                            const int* __restrict__ var_edges, int m, int dmax,
                            int n, int vdeg, int iters, float alpha) {
  extern __shared__ int shm[];
  int* cv = shm;                    // [m * dmax] variable per check slot
  int* ve = cv + m * dmax;          // [n * vdeg] edge per variable slot
  float* c2v = reinterpret_cast<float*>(ve + n * vdeg);  // [m * dmax]
  float* tot = c2v + m * dmax;      // [n]

  const int t = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  for (int i = t; i < m * dmax; i += blockDim.x) {
    cv[i] = chk_vars[i];
    c2v[i] = 0.0f;
  }
  for (int i = t; i < n * vdeg; i += blockDim.x) ve[i] = var_edges[i];
  const float llr = t < n ? llrs[row + t] : 0.0f;
  __syncthreads();

  float total = 0.0f;
  for (int it = 0; it <= iters; ++it) {
    // variable totals: channel LLR + incoming check messages
    if (t < n) {
      float acc = 0.0f;
      for (int j = 0; j < vdeg; ++j) {
        const int e = ve[t * vdeg + j];
        acc = __fadd_rn(acc, e >= 0 ? c2v[e] : 0.0f);
      }
      total = __fadd_rn(llr, acc);
      tot[t] = total;
    }
    if (it == iters) break;
    __syncthreads();
    // check update for check t (normalised min-sum)
    if (t < m) {
      float sg[kMaxDeg], mg[kMaxDeg];
      float tot_sgn = 1.0f, m1 = INFINITY;
      int arg1 = 0;
      for (int j = 0; j < dmax; ++j) {
        const int v = cv[t * dmax + j];
        if (v >= 0) {
          const float x = __fsub_rn(tot[v], c2v[t * dmax + j]);
          sg[j] = x >= 0.0f ? 1.0f : -1.0f;
          mg[j] = fabsf(x);
        } else {
          sg[j] = 1.0f;
          mg[j] = INFINITY;
        }
        tot_sgn *= sg[j];
        if (mg[j] < m1) {
          m1 = mg[j];
          arg1 = j;
        }
      }
      float m2 = INFINITY;
      for (int j = 0; j < dmax; ++j) {
        if (j != arg1) m2 = fminf(m2, mg[j]);
      }
      for (int j = 0; j < dmax; ++j) {
        if (cv[t * dmax + j] < 0) continue;
        const float mag = fminf(mg[j] == m1 ? m2 : m1, 1e30f);
        c2v[t * dmax + j] = __fmul_rn(__fmul_rn(alpha, tot_sgn * sg[j]), mag);
      }
    }
    __syncthreads();
  }
  if (t < n) totals[row + t] = total;
}

}  // namespace

extern "C" int pm_ldpc_totals(const void* llrs, void* totals,
                              const void* chk_vars, const void* var_edges,
                              int b, int m, int dmax, int n, int vdeg,
                              int iters, float alpha, void* stream) {
  if (dmax > kMaxDeg) return static_cast<int>(cudaErrorInvalidValue);
  int threads = (n > m ? n : m);
  threads = (threads + 31) / 32 * 32;
  const size_t smem = sizeof(int) * (m * dmax + n * vdeg) +
                      sizeof(float) * (m * dmax + n);
  ldpc_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llrs), static_cast<float*>(totals),
      static_cast<const int*>(chk_vars), static_cast<const int*>(var_edges), m,
      dmax, n, vdeg, iters, alpha);
  return static_cast<int>(cudaGetLastError());
}
