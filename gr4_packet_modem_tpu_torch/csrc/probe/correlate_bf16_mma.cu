// K1's bf16 form at N = 4096 and 8192 as it was before its Hopper
// redesign: one warp a frame with mma.sync.m16n8k16, the bulk table W2c
// (256 KB, 1 MB) read in mma's B-fragment order through L1, both products
// from it (the forward one with kConj), the A operand from a padded shared
// tile with ldmatrix, the spectrum in shared memory. Kept as a probe so
// that chip_smoke.py can time the redesign against it in one call; built on
// its own (ops/_build.py::build_single), never part of the port's library.
// Its inputs: the replica spectra in the accumulator's fragment order
// (acquire_cuda.py::fragment_index), W2c as mma's B fragments
// (chip_smoke.py::mma_fragment_table), F1 and W1c rounded to bf16 and the
// twiddles as the port's kernel takes them. No fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN1 = 16;    // the small radix
constexpr int kUld = 40;   // float row stride of the column-exchange tile

// F1 [k1][m1] then W1c [n1][k1], rounded to bf16, as float2 (re, im)
__constant__ float2 c_small[2 * kN1 * kN1];

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// The forward radix-16 DFT and twiddle of the frame's columns m2 = lane +
// 32 c, rounded to bf16 into the A tile (planes tre, tim, row stride ld);
// a frame that does not exist (live false) is zeros
template <int N2>
__device__ __forceinline__ void forward_columns(const float* fa_r, const float* fa_i,
                                                const float* fb_r, const float* fb_i,
                                                const float2* twf, __nv_bfloat16* tre,
                                                __nv_bfloat16* tim, int ld, int s, bool live,
                                                int lane) {
#pragma unroll 2
  for (int c = 0; c < N2 / 32; ++c) {
    const int m2 = lane + 32 * c;
    float2 x[kN1];
#pragma unroll
    for (int m1 = 0; m1 < kN1; ++m1) {
      const int n = N2 * m1 + m2;
      x[m1] = !live ? make_float2(0.0f, 0.0f)
                    : (n < s ? make_float2(fa_r[n], fa_i[n]) : make_float2(fb_r[n - s], fb_i[n - s]));
    }
    float2 a[kN1];
    small_dft<false>(x, a, 0);
#pragma unroll
    for (int k1 = 0; k1 < kN1; ++k1) {
      const float2 t = __ldg(twf + k1 * N2 + m2);
      tre[k1 * ld + m2] = __float2bfloat16_rn(a[k1].x * t.x - a[k1].y * t.y);
      tim[k1 * ld + m2] = __float2bfloat16_rn(a[k1].x * t.y + a[k1].y * t.x);
    }
  }
}

// ------------------------------------------- N = 4096, 8192: mma.sync

template <int N2>
struct Plan {
  static constexpr int kNT = N2 / 8;    // n-tiles of a bulk product
  static constexpr int kKS = N2 / 16;   // k-steps of a bulk product
  static constexpr int kGroups = N2 / 32;  // groups of four n-tiles
  static constexpr int kWarps = N2 == 256 ? 3 : 1;
  static constexpr int kLd = N2 + 8;    // bf16 row stride of the A tile
  // a warp's shared memory: the A tile (re, im planes), the column-exchange
  // tile (re, im), the forward spectrum (fragment order), the running max
  // and the bin
  static constexpr int kTile = 2 * kN1 * kLd * 2;
  static constexpr int kExch = 2 * kN1 * kUld * 4;
  static constexpr int kSpec = kN1 * N2 * 8;
  static constexpr int kMax = kN1 * N2 * 4;
  static constexpr int kBin = kN1 * N2;
  static constexpr int kWarpBytes = kTile + kExch + kSpec + kMax + kBin;
  static constexpr int kBytes = kWarps * kWarpBytes;
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

// acc[j] = (re, im) accumulator fragments of n-tile 4 g + j of the complex
// product A @ W (kConj false) or A @ conj(W) (kConj true): A the warp's bf16
// tile (planes re, im), W the W2c table in fragment order [n-tile][k-step]
// [lane] of uint4 (re b0, re b1, im b0, im b1), read through L1
template <int N2, bool kConj>
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
    uint32_t are[4], aim[4], neg[4];
    load_a(are, tre + 16 * ks, P::kLd, lane);
    load_a(aim, tim + 16 * ks, P::kLd, lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) neg[c] = (kConj ? are[c] : aim[c]) ^ 0x80008000u;  // exact
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 b = __ldg(tab + ((4 * g + j) * P::kKS + ks) * 32 + lane);
      if constexpr (kConj) {  // re = Ar Wr + Ai Wi, im = Ai Wr - Ar Wi
        mma(acc[j][0], are, b.x, b.y);
        mma(acc[j][0], aim, b.z, b.w);
        mma(acc[j][1], aim, b.x, b.y);
        mma(acc[j][1], neg, b.z, b.w);
      } else {  // re = Ar Wr - Ai Wi, im = Ar Wi + Ai Wr
        mma(acc[j][0], are, b.x, b.y);
        mma(acc[j][0], neg, b.z, b.w);
        mma(acc[j][1], are, b.z, b.w);
        mma(acc[j][1], aim, b.x, b.y);
      }
    }
  }
}

template <int N2>
__global__ void __launch_bounds__(32 * Plan<N2>::kWarps, 1)
correlate_bf16_mma(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ br, const float* __restrict__ bi,
                   const float4* __restrict__ rep, const uint4* __restrict__ w2c,
                   const float2* __restrict__ tw, float* __restrict__ out_pow,
                   int* __restrict__ out_bin, int fpad, int s, int nb) {
  using P = Plan<N2>;
  constexpr int kN = kN1 * N2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * P::kWarps + warp;
  if (f >= fpad) return;

  unsigned char* base = smem + warp * P::kWarpBytes;
  __nv_bfloat16* tre = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* tim = tre + kN1 * P::kLd;
  float* ure = reinterpret_cast<float*>(base + P::kTile);
  float* uim = ure + kN1 * kUld;
  // the forward spectrum in the accumulator's fragment order: n-tile nt's
  // real and imaginary fragments of the lane at spec[(2 nt + part) * 32 + lane]
  float4* spec = reinterpret_cast<float4*>(base + P::kTile + P::kExch);
  float* pmax = reinterpret_cast<float*>(base + P::kTile + P::kExch + P::kSpec);
  unsigned char* pbin = base + P::kTile + P::kExch + P::kSpec + P::kMax;
  const float2* twf = tw;            // [k1][m2]
  const float2* twi = tw + kN1 * N2;  // [k1][n2]

  forward_columns<N2>(ar + f * s, ai + f * s, br + f * s, bi + f * s, twf, tre, tim, P::kLd, s,
                      true, lane);
  __syncwarp();

  // forward bulk DFT, Y = N2 (B @ conj(W2c))
#pragma unroll
  for (int g = 0; g < P::kGroups; ++g) {
    float acc[4][2][4];
    bulk_product<N2, true>(acc, tre, tim, w2c, g, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float n2 = static_cast<float>(N2);  // exact
      spec[(2 * (4 * g + j)) * 32 + lane] =
          make_float4(n2 * acc[j][0][0], n2 * acc[j][0][1], n2 * acc[j][0][2], n2 * acc[j][0][3]);
      spec[(2 * (4 * g + j) + 1) * 32 + lane] =
          make_float4(n2 * acc[j][1][0], n2 * acc[j][1][1], n2 * acc[j][1][2], n2 * acc[j][1][3]);
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
      const float4 yr = spec[(2 * nt) * 32 + lane];
      const float4 yi = spec[(2 * nt + 1) * 32 + lane];
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
      bulk_product<N2, false>(acc, tre, tim, w2c, g, lane);
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
int launch(const float* ar, const float* ai, const float* br, const float* bi, const float4* rep,
           const uint4* w2c, const float2* tw, float* out_pow, int* out_bin, int fpad, int s,
           int nb, cudaStream_t st) {
  using P = Plan<N2>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      correlate_bf16_mma<N2>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes));
  if (err != 0) return err;
  const int blocks = (fpad + P::kWarps - 1) / P::kWarps;
  correlate_bf16_mma<N2><<<blocks, 32 * P::kWarps, P::kBytes, st>>>(ar, ai, br, bi, rep, w2c, tw,
                                                                   out_pow, out_bin, fpad, s, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// log2n in {12, 13}; the arguments as pm_correlate_bf16 takes them, with rep
// and w2c in the layouts above
extern "C" int pm_correlate_bf16_mma(const void* ar, const void* ai, const void* br, const void* bi,
                                     const void* rep, const void* w2c, const void* small,
                                     const void* tw, void* out_pow, void* out_bin, int fpad, int s,
                                     int nb, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaMemcpyToSymbolAsync(c_small, small, sizeof(c_small), 0,
                                                     cudaMemcpyDeviceToDevice, st));
  if (err != 0) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const float4* r = static_cast<const float4*>(rep);
  const uint4* t = static_cast<const uint4*>(w2c);
  const float2* w = static_cast<const float2*>(tw);
  float* op = static_cast<float*>(out_pow);
  int* ob = static_cast<int*>(out_bin);
  if (log2n == 12) return launch<256>(f(ar), f(ai), f(br), f(bi), r, t, w, op, ob, fpad, s, nb, st);
  if (log2n == 13) return launch<512>(f(ar), f(ai), f(br), f(bi), r, t, w, op, ob, fpad, s, nb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
