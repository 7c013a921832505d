// K1 fused correlator, bf16 form: for every frame, the best power over the nb
// replica spectra and its bin,
//   best_pow[f, j] = max_b |y_b[j]|^2,  best_bin = first argmax,
// with the correlation y_b computed as the TPU kernel computes it in its
// bf16 form: the forward and every inverse DFT factored as N = 16 x N2,
//   A  = F1 @ X              radix-16 DFT over m1 (float32, F1 rounded to bf16)
//   B  = A * TWF             twiddle (float32)
//   Y  = bf16(B) @ bf16(F2)  bulk DFT over m2, float32 accumulation
//   P  = Y * R_b             the replica spectrum in the [k1, k2] layout
//   U  = bf16(P) @ bf16(W2c) bulk inverse DFT over k2, float32 accumulation
//   V  = U * TW              twiddle (float32)
//   y  = W1c @ V             radix-16 inverse DFT over k1 (float32, W1c in bf16)
// where x[N2 m1 + m2] = X[m1, m2] is the frame and y[N2 n1 + n2] = y[n1, n2]
// the output sample. Frame f is row f of the body plane a (S samples)
// followed by the first N - S samples of row f of the one-stride-shifted
// plane b, as for the float32 kernel (correlate.cu).
//
// Replaces gr4_packet_modem_tpu/ops/acquire_pallas.py::fused_best_power with
// bf16=True (_make_kernel: the casts at :235-249 and :270-272, launched by
// pl.pallas_call at :375). On the TPU the four-step factorization keeps every
// contraction a matrix product for the MXU; here the two bulk products a bin
// (and the forward one) run on the tensor cores as bf16 x bf16 -> float32,
// and the radix-16 DFTs, which the TPU kernel computes from float32 data,
// stay on the CUDA cores in float32.
//
// Bound: bf16 tensor-core operations. At the bench shape (20,480 frames,
// N = 2048, 9 bins) a frame is about 21 MFLOP of bf16 tensor-core work
// (0.43 ms at 989 TFLOP/s), 1.0 MFLOP of float32 radix-16 DFTs (as
// small_dft runs them) and elementwise work (0.32 ms at 67 TFLOP/s) and
// 30 KB of device memory traffic (0.19 ms).
// Design: one warp owns one frame. The 16 rows of a frame (k1) are one m16
// tile of mma.sync.m16n8k16 (bf16 in, float32 accumulate); a bulk product
// [16, N2] @ [N2, N2] is N2/8 n-tiles x N2/16 k-steps x 4 real products.
// The A operand (the data, rounded to bf16) sits in a padded row-major tile
// in shared memory and is read with ldmatrix; the B operand (the table) comes
// from a host-built table in fragment order, one 16-byte load a lane for the
// real and imaginary fragments, kept in shared memory at N2 = 128 (the inverse
// table, 64 KB, read nine times a frame) and read through L1 from device
// memory otherwise. The forward spectrum Y stays in the accumulator's own
// fragment order, so a bin's product with R_b (laid out by the wrapper in the
// same order) needs no exchange: in registers at N2 = 128, which leaves room
// in shared memory for six warps a block, and in shared memory at N2 = 256
// and 512 (each lane reads back what it wrote). Each group of four n-tiles of
// the inverse product (32 columns) is exchanged once through a small shared
// tile so that a lane owns one column and runs its radix-16 DFT, power and
// running max (strict >, from -1, so the lowest bin wins a tie) with
// warp-uniform coefficients: the radix-16 tables are in constant memory and
// enter the FMAs as operands, and each radix-16 DFT runs as four 4-term
// partial sums a row and a 4-point DFT over them (small_dft), a quarter of
// the dense product's multiply-adds on the same rounded coefficients. The
// running max and bin wait in shared memory (each lane its own) and go to
// device memory once a frame, coalesced, in natural order j = N2 n1 + n2.
// No fast math. What holds it from its bound is latency: a few warps an SM
// (shared memory), each a chain of ldmatrix, mma and exchanges.
// Left for later: the bf16 product as registers that feed the inverse
// product directly, wgmma and TMA for the bulk products, and the radix-16
// DFTs on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kN1 = 16;    // the small radix
constexpr int kUld = 40;   // float row stride of the column-exchange tile

// F1 [k1][m1] then W1c [n1][k1], rounded to bf16, as float2 (re, im)
__constant__ float2 c_small[2 * kN1 * kN1];

template <int N2>
struct Plan {
  static constexpr int kNT = N2 / 8;    // n-tiles of a bulk product
  static constexpr int kKS = N2 / 16;   // k-steps of a bulk product
  static constexpr int kGroups = N2 / 32;  // groups of four n-tiles
  static constexpr bool kSmemTable = N2 == 128;
  // the forward spectrum in registers (128 floats a lane at N2 = 128)
  static constexpr bool kRegSpec = N2 == 128;
  static constexpr int kWarps = N2 == 128 ? 6 : (N2 == 256 ? 3 : 1);
  static constexpr int kLd = N2 + 8;    // bf16 row stride of the A tile
  // a warp's shared memory: the A tile (re, im planes), the column-exchange
  // tile (re, im), the forward spectrum (fragment order), the running max
  // and the bin
  static constexpr int kTile = 2 * kN1 * kLd * 2;
  static constexpr int kExch = 2 * kN1 * kUld * 4;
  static constexpr int kSpec = kRegSpec ? 0 : kN1 * N2 * 8;
  static constexpr int kMax = kN1 * N2 * 4;
  static constexpr int kBin = kN1 * N2;
  static constexpr int kWarpBytes = kTile + kExch + kSpec + kMax + kBin;
  static constexpr int kTableBytes = kSmemTable ? kNT * kKS * 32 * 16 : 0;
  static constexpr int kBytes = kTableBytes + kWarps * kWarpBytes;
  static_assert(kBytes <= 232448, "a block's shared memory");
  static_assert(kWarpBytes % 16 == 0 && kTile % 16 == 0 && kExch % 16 == 0, "alignment");
};

// d += a @ b on one m16n8k16 tile: bf16 inputs, float32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16 x 16 bf16 tile whose rows start at p (row stride ld
// elements): lane i gives the address of row i % 16's half i / 16
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* p, int ld,
                                       int lane) {
  const __nv_bfloat16* q = p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(q));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

template <bool kShared>
__device__ __forceinline__ uint4 load_b(const uint4* t, int i) {
  if constexpr (kShared) {
    return t[i];
  } else {
    return __ldg(t + i);
  }
}

// acc[j] = (re, im) accumulator fragments of n-tile 4 g + j of the complex
// product A @ T: A the warp's bf16 tile (planes re, im), T a table in
// fragment order [n-tile][k-step][lane] of uint4 (re b0, re b1, im b0, im b1)
template <int N2, bool kShared>
__device__ __forceinline__ void bulk_product(float (&acc)[4][2][4], const __nv_bfloat16* tre,
                                             const __nv_bfloat16* tim, const uint4* tab, int g,
                                             int lane) {
  using P = Plan<N2>;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][0][c] = acc[j][1][c] = 0.0f;
#pragma unroll 2
  for (int ks = 0; ks < P::kKS; ++ks) {
    uint32_t are[4], aim[4], ain[4];
    load_a(are, tre + 16 * ks, P::kLd, lane);
    load_a(aim, tim + 16 * ks, P::kLd, lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) ain[c] = aim[c] ^ 0x80008000u;  // -im, exact
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 b = load_b<kShared>(tab, ((4 * g + j) * P::kKS + ks) * 32 + lane);
      mma(acc[j][0], are, b.x, b.y);
      mma(acc[j][0], ain, b.z, b.w);
      mma(acc[j][1], are, b.z, b.w);
      mma(acc[j][1], aim, b.x, b.y);
    }
  }
}

// y = W @ v for the 16 x 16 table W at c_small + base (rounded to bf16): the
// forward F1 (kInv false) or the inverse W1c. Rows n + 4 m of a DFT table are
// row n times s^(m k) column by column (s = j for the inverse, -j for the
// forward), and rounding to bf16 keeps that (it commutes with negation and
// swaps re and im alike), so y[n + 4 m] = sum_r s^(m r) S_r[n] with
// S_r[n] = sum over k = r mod 4 of W[n][k] v[k]: the dense product's terms
// in another order, a quarter of its multiply-adds.
template <bool kInv>
__device__ __forceinline__ void small_dft(const float2 (&v)[kN1], float2 (&y)[kN1], int base) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float2 sr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float re = 0.0f, im = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = r + 4 * i;
        const float2 w = c_small[base + n * kN1 + k];
        re = fmaf(w.x, v[k].x, re);
        re = fmaf(-w.y, v[k].y, re);
        im = fmaf(w.x, v[k].y, im);
        im = fmaf(w.y, v[k].x, im);
      }
      sr[r] = make_float2(re, im);
    }
    const float2 a = make_float2(sr[0].x + sr[2].x, sr[0].y + sr[2].y);
    const float2 b = make_float2(sr[0].x - sr[2].x, sr[0].y - sr[2].y);
    const float2 c = make_float2(sr[1].x + sr[3].x, sr[1].y + sr[3].y);
    const float2 d = make_float2(sr[1].x - sr[3].x, sr[1].y - sr[3].y);
    // s d: j d for the inverse, -j d for the forward
    const float2 sd = kInv ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
    y[n] = make_float2(a.x + c.x, a.y + c.y);
    y[n + 4] = make_float2(b.x + sd.x, b.y + sd.y);
    y[n + 8] = make_float2(a.x - c.x, a.y - c.y);
    y[n + 12] = make_float2(b.x - sd.x, b.y - sd.y);
  }
}

// The forward spectrum Y in the accumulator's fragment order: n-tile nt's
// real and imaginary fragments of the lane. In registers (every index a
// compile-time constant: the loops over n-tiles are unrolled), or in the
// warp's shared memory at p[(2 nt + part) * 32 + lane].
template <int N2>
struct RegSpectrum {
  float4 v[N2 / 8][2];
  __device__ __forceinline__ void put(int nt, int, float4 re, float4 im) {
    v[nt][0] = re;
    v[nt][1] = im;
  }
  __device__ __forceinline__ float4 re(int nt, int) const { return v[nt][0]; }
  __device__ __forceinline__ float4 im(int nt, int) const { return v[nt][1]; }
};

struct SharedSpectrum {
  float4* p;
  __device__ __forceinline__ void put(int nt, int lane, float4 re, float4 im) {
    p[(2 * nt) * 32 + lane] = re;
    p[(2 * nt + 1) * 32 + lane] = im;
  }
  __device__ __forceinline__ float4 re(int nt, int lane) const { return p[(2 * nt) * 32 + lane]; }
  __device__ __forceinline__ float4 im(int nt, int lane) const { return p[(2 * nt + 1) * 32 + lane]; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N2>
__global__ void __launch_bounds__(32 * Plan<N2>::kWarps, 1)
correlate_bf16_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                      const float* __restrict__ br, const float* __restrict__ bi,
                      const float4* __restrict__ rep, const uint4* __restrict__ fwd,
                      const uint4* __restrict__ inv, const float2* __restrict__ tw,
                      float* __restrict__ out_pow, int* __restrict__ out_bin, int fpad, int s,
                      int nb) {
  using P = Plan<N2>;
  constexpr int kN = kN1 * N2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint4* inv_s = reinterpret_cast<uint4*>(smem);
  if constexpr (P::kSmemTable) {
    for (int k = threadIdx.x; k < P::kNT * P::kKS * 32; k += blockDim.x) inv_s[k] = inv[k];
  }
  __syncthreads();  // the only block-wide barrier
  const int64_t f = static_cast<int64_t>(blockIdx.x) * P::kWarps + warp;
  if (f >= fpad) return;

  unsigned char* base = smem + P::kTableBytes + warp * P::kWarpBytes;
  __nv_bfloat16* tre = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* tim = tre + kN1 * P::kLd;
  float* ure = reinterpret_cast<float*>(base + P::kTile);
  float* uim = ure + kN1 * kUld;
  std::conditional_t<P::kRegSpec, RegSpectrum<N2>, SharedSpectrum> spec;
  if constexpr (!P::kRegSpec) spec.p = reinterpret_cast<float4*>(base + P::kTile + P::kExch);
  float* pmax = reinterpret_cast<float*>(base + P::kTile + P::kExch + P::kSpec);
  unsigned char* pbin = base + P::kTile + P::kExch + P::kSpec + P::kMax;
  const float2* twf = tw;            // [k1][m2]
  const float2* twi = tw + kN1 * N2;  // [k1][n2]

  // forward radix-16 DFT and twiddle: the lane owns columns m2 = lane + 32 c
  const float* fa_r = ar + f * s;
  const float* fa_i = ai + f * s;
  const float* fb_r = br + f * s;
  const float* fb_i = bi + f * s;
#pragma unroll 1
  for (int c = 0; c < P::kGroups; ++c) {
    const int m2 = lane + 32 * c;
    float2 x[kN1];
#pragma unroll
    for (int m1 = 0; m1 < kN1; ++m1) {
      const int n = N2 * m1 + m2;
      x[m1] = n < s ? make_float2(fa_r[n], fa_i[n]) : make_float2(fb_r[n - s], fb_i[n - s]);
    }
    float2 a[kN1];
    small_dft<false>(x, a, 0);
#pragma unroll
    for (int k1 = 0; k1 < kN1; ++k1) {
      const float2 t = __ldg(twf + k1 * N2 + m2);
      tre[k1 * P::kLd + m2] = __float2bfloat16_rn(a[k1].x * t.x - a[k1].y * t.y);
      tim[k1 * P::kLd + m2] = __float2bfloat16_rn(a[k1].x * t.y + a[k1].y * t.x);
    }
  }
  __syncwarp();

  // forward bulk DFT: the spectrum in fragment order
#pragma unroll
  for (int g = 0; g < P::kGroups; ++g) {
    float acc[4][2][4];
    bulk_product<N2, false>(acc, tre, tim, fwd, g, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      spec.put(4 * g + j, lane, make_float4(acc[j][0][0], acc[j][0][1], acc[j][0][2], acc[j][0][3]),
               make_float4(acc[j][1][0], acc[j][1][1], acc[j][1][2], acc[j][1][3]));
    }
  }
#pragma unroll 1
  for (int k = lane; k < kN1 * N2; k += 32) {
    pmax[k] = -1.0f;
    pbin[k] = 0;
  }

  const int gid = lane >> 2;  // fragment row
  const int tig = lane & 3;   // fragment column pair
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    __syncwarp();  // the A tile's last readers are done
    // P = Y * R_b, rounded to bf16 into the A tile: the lane's fragment
    // values sit at rows gid, gid + 8, columns 8 nt + 2 tig, + 1
    const float4* rb = rep + static_cast<int64_t>(b) * P::kNT * 64;
#pragma unroll
    for (int nt = 0; nt < P::kNT; ++nt) {
      const float4 yr = spec.re(nt, lane);
      const float4 yi = spec.im(nt, lane);
      const float4 rr = __ldg(rb + (2 * nt) * 32 + lane);
      const float4 ri = __ldg(rb + (2 * nt + 1) * 32 + lane);
      const int col = 8 * nt + 2 * tig;
      uint32_t* r0 = reinterpret_cast<uint32_t*>(tre + gid * P::kLd + col);
      uint32_t* r8 = reinterpret_cast<uint32_t*>(tre + (gid + 8) * P::kLd + col);
      uint32_t* i0 = reinterpret_cast<uint32_t*>(tim + gid * P::kLd + col);
      uint32_t* i8 = reinterpret_cast<uint32_t*>(tim + (gid + 8) * P::kLd + col);
      *r0 = pack_bf16(yr.x * rr.x - yi.x * ri.x, yr.y * rr.y - yi.y * ri.y);
      *r8 = pack_bf16(yr.z * rr.z - yi.z * ri.z, yr.w * rr.w - yi.w * ri.w);
      *i0 = pack_bf16(yr.x * ri.x + yi.x * rr.x, yr.y * ri.y + yi.y * rr.y);
      *i8 = pack_bf16(yr.z * ri.z + yi.z * rr.z, yr.w * ri.w + yi.w * rr.w);
    }
    __syncwarp();
#pragma unroll 1
    for (int g = 0; g < P::kGroups; ++g) {
      float acc[4][2][4];
      if constexpr (P::kSmemTable) {
        bulk_product<N2, true>(acc, tre, tim, inv_s, g, lane);
      } else {
        bulk_product<N2, false>(acc, tre, tim, inv, g, lane);
      }
      // the group's U [16, 32] through the exchange tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(ure + gid * kUld + col) = make_float2(acc[j][0][0], acc[j][0][1]);
        *reinterpret_cast<float2*>(ure + (gid + 8) * kUld + col) = make_float2(acc[j][0][2], acc[j][0][3]);
        *reinterpret_cast<float2*>(uim + gid * kUld + col) = make_float2(acc[j][1][0], acc[j][1][1]);
        *reinterpret_cast<float2*>(uim + (gid + 8) * kUld + col) = make_float2(acc[j][1][2], acc[j][1][3]);
      }
      __syncwarp();
      // the lane's column n2: twiddle, radix-16 inverse DFT, power, max
      const int n2 = 32 * g + lane;
      float2 v[kN1];
#pragma unroll
      for (int k1 = 0; k1 < kN1; ++k1) {
        const float u_r = ure[k1 * kUld + lane];
        const float u_i = uim[k1 * kUld + lane];
        const float2 t = __ldg(twi + k1 * N2 + n2);
        v[k1] = make_float2(u_r * t.x - u_i * t.y, u_r * t.y + u_i * t.x);
      }
      __syncwarp();  // the exchange tile is free for the next group
      float2 y[kN1];
      small_dft<true>(v, y, kN1 * kN1);
#pragma unroll
      for (int n1 = 0; n1 < kN1; ++n1) {
        const float p = y[n1].x * y[n1].x + y[n1].y * y[n1].y;
        const int slot = (g * kN1 + n1) * 32 + lane;
        if (p > pmax[slot]) {
          pmax[slot] = p;
          pbin[slot] = static_cast<unsigned char>(b);
        }
      }
    }
  }

  float* op = out_pow + f * kN;
  int* ob = out_bin + f * kN;
#pragma unroll 1
  for (int g = 0; g < P::kGroups; ++g) {
#pragma unroll
    for (int n1 = 0; n1 < kN1; ++n1) {
      const int slot = (g * kN1 + n1) * 32 + lane;
      op[N2 * n1 + 32 * g + lane] = pmax[slot];
      ob[N2 * n1 + 32 * g + lane] = pbin[slot];
    }
  }
}

template <int N2>
int launch(const void* ar, const void* ai, const void* br, const void* bi, const void* rep,
           const void* fwd, const void* inv, const void* small, const void* tw, void* out_pow,
           void* out_bin, int fpad, int s, int nb, cudaStream_t stream) {
  using P = Plan<N2>;
  cudaError_t err = cudaFuncSetAttribute(correlate_bf16_kernel<N2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyToSymbolAsync(c_small, small, sizeof(c_small), 0, cudaMemcpyDeviceToDevice,
                                stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (fpad + P::kWarps - 1) / P::kWarps;
  correlate_bf16_kernel<N2><<<blocks, 32 * P::kWarps, P::kBytes, stream>>>(
      static_cast<const float*>(ar), static_cast<const float*>(ai),
      static_cast<const float*>(br), static_cast<const float*>(bi),
      static_cast<const float4*>(rep), static_cast<const uint4*>(fwd),
      static_cast<const uint4*>(inv), static_cast<const float2*>(tw),
      static_cast<float*>(out_pow), static_cast<int*>(out_bin), fpad, s, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// log2n in {11, 12, 13}: N = 2048, 4096 or 8192; 1 <= nb <= 256 and fpad >= 1
// (the wrapper checks them). rep: the replica spectra in fragment order;
// fwd, inv: the bf16 bulk DFT tables in fragment order; small: F1 and W1c
// rounded to bf16; tw: the forward and inverse twiddles
// (ops/acquire_cuda.py::bf16_tables, replica_table_bf16).
extern "C" int pm_correlate_bf16(const void* ar, const void* ai, const void* br, const void* bi,
                                 const void* rep, const void* fwd, const void* inv,
                                 const void* small, const void* tw, void* out_pow, void* out_bin,
                                 int fpad, int s, int nb, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 11:
      return launch<128>(ar, ai, br, bi, rep, fwd, inv, small, tw, out_pow, out_bin, fpad, s, nb, st);
    case 12:
      return launch<256>(ar, ai, br, bi, rep, fwd, inv, small, tw, out_pow, out_bin, fpad, s, nb, st);
    case 13:
      return launch<512>(ar, ai, br, bi, rep, fwd, inv, small, tw, out_pow, out_bin, fpad, s, nb, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
