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
// contraction a matrix product for the MXU; here the bulk products run on the
// tensor cores as bf16 x bf16 -> float32, and the radix-16 DFTs, which the
// TPU kernel computes from float32 data, stay on the CUDA cores in float32.
//
// One table. Rounded to bf16, F2 is N2 times the conjugate of W2c, bit for
// bit (rounding commutes with negation and with a power of two), so both
// bulk products read W2c alone: Y = N2 (B @ conj(W2c)), the scaling exact in
// float32. The forward table and its stream from device memory are gone.
//
// Bound (NVIDIA H100 80GB HBM3, 700 W): bf16 tensor-core operations. At the
// bench shape (20,480 frames, N = 2048, 9 bins) a frame is about 21 MFLOP
// of bf16 tensor-core work (0.43 ms at 989 TFLOP/s), 1.0 MFLOP of float32
// radix-16 DFTs (as small_dft runs them) and elementwise work (0.32 ms at
// 67 TFLOP/s) and 30 KB of device memory traffic (0.19 ms).
//
// Design at N = 2048 (correlate_bf16_wgmma): persistent blocks of two
// warpgroups, one block an SM, at most as many blocks as the card holds at
// once. A block loads its table once, with one bulk copy (cp.async.bulk)
// completing on an mbarrier: W2c's first 64 columns (32 KB), since column
// n + 64 is column n times (-1)^k, which the kernel applies to the A
// operand (the odd columns' sign bits). In the rounded table this holds
// bit for bit but at the entries whose exact value is 0, where the float32
// table has rounding noise under 1e-15 (6.25 % of them at most): the kernel
// takes the first half's noise there. The table is in wgmma's layout:
// core matrices of 8 columns x 8 rows (k), 16 bytes a column, no swizzle.
// Each warpgroup then walks over groups of four frames (group g, then g + 2
// blocks, ...); warp w of the warpgroup owns frame 4 g + w, and a ragged
// last group computes zeros in its missing warps and stores nothing for
// them. The four frames' 16 rows (k1) are one M = 64 tile of
// wgmma.m64n64k16 (bf16 in, float32 accumulate), each warp's 16 rows its
// own frame's; a product runs in two halves of 64 columns, K = 16 a step,
// B the table in shared memory, A in registers, each product's sign on
// its A operand (scale-a):
// - forward: the radix-16 DFT and twiddle put bf16(B) into the warp's
//   row-major A tile, ldmatrix gives the A fragments, and wgmma gives
//   Y / N2 = B @ conj(W2c). Y (scaled by N2, exact) goes to the warp's 16
//   KB of shared memory in the accumulator's fragment order, which for each
//   8 columns is mma.m16n8's; the A tile lay there before;
// - inverse, a half of the columns at a time and the bins inner: each
//   lane's two columns keep their running max (strict >, from -1, so the
//   lowest bin wins a tie) and bin (a byte) in registers. For each bin the
//   A fragments of bf16(P), P = Y * R_b, are computed from the lane's own
//   fragments of Y and of R_b (laid out by the wrapper in the same order):
//   a pair of m16n8 accumulator tiles is one m16k16 A fragment, so P never
//   goes through memory. U then passes 32 columns at a time through a 4 KB
//   shared tile (XOR-swizzled, free of bank conflicts both ways) so that a
//   lane owns one column and runs its twiddle, radix-16 inverse DFT
//   (small_dft), power and running max with warp-uniform coefficients from
//   constant memory. The outputs go to device memory once a frame and half,
//   coalesced, in natural order j = N2 n1 + n2.
// Eight frames in flight an SM: Y in shared memory (16 KB a frame) and
// registers (255 a thread, in the build log) allow no more. The block's
// shared memory stays within 196 KB so that the SM keeps 60 KB of L1 for
// R_b (16 KB a bin, prefetched into L1 for the next product while this
// one's DFTs run) and the twiddles; a warp's next frame is prefetched into
// L2 while its group's inverse runs. The tensor cores and the float32 work
// overlap across the SM's two warpgroups only: each warpgroup waits for its
// own product. Tried on the card and slower, so not kept: the next bin's
// product issued before this bin's DFTs (with a 64-column exchange tile,
// or as two groups of 32 columns), Y in registers, products of 32 columns,
// R_b in shared memory by bulk copy, and a warp-specialized block (one
// product warpgroup fed P through shared memory by two DFT warpgroups).
// What holds it from its bound is each warp's serial chain at two warps a
// scheduler: the P fragments, the product's latency, the float32 DFTs.
//
// Design at N = 4096 and 8192 (correlate_bf16_mma): PR 12's, one warp a
// frame with mma.sync.m16n8k16: the table (256 KB, 1 MB) exceeds shared
// memory and is read in mma's fragment order through L1, both products
// from it (the forward one with kConj), the A operand from a padded shared
// tile with ldmatrix, the spectrum in shared memory.
// No fast math.
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

// ------------------------------------------------------ N = 2048: wgmma

namespace wg {
constexpr int kN2 = 128;
constexpr int kGroups = 2;   // warpgroups a block
constexpr int kFrames = 4;   // frames a warpgroup: one a warp
constexpr int kThreads = 128 * kGroups;
constexpr int kKS = kN2 / 16;   // k-steps of a product
constexpr int kHalf = kN2 / 2;  // a product's columns (wgmma's N), the table's
constexpr int kCore = 128;      // bytes of a core matrix (8 x 8 bf16)
// the table: W2c's columns 0 .. 63 (W2c[k][n + 64] = (-1)^k W2c[k][n]
// up to rounding noise where the exact value is 0),
// plane p (0 re, 1 im), core matrix (n / 8, k / 8) at (8 p + n / 8) kSbo +
// (k / 8) kLbo; within it column n % 8 at 16 (n % 8) and row k % 8 at
// 2 (k % 8) bytes
constexpr int kLbo = kCore;            // next 8 rows (k) of a column block
constexpr int kSbo = kN2 / 8 * kCore;  // next 8 columns (n)
constexpr int kTableBytes = 2 * kN2 * kHalf * 2;
constexpr int kLd = kN2 + 8;  // bf16 row stride of the A tile
constexpr int kTile = 2 * kN1 * kLd * 2;
constexpr int kSpec = kN1 * kN2 * 8;  // the forward spectrum, fragment order
constexpr int kExch = 2 * kN1 * 32 * 4;  // 32 columns of U, re and im
constexpr int kRepBin = kN2 / 8 * 64;    // float4 of a bin's replica fragments
// a warp's shared memory: the forward spectrum, where the A tile lies
// until the forward product has read it, then the column-exchange tile
constexpr int kWarpBytes = kSpec + kExch;
constexpr int kBytes = kTableBytes + kGroups * kFrames * kWarpBytes;
static_assert(kTile <= kSpec, "the A tile overlays the spectrum");
// at most 196 KB with the block's static and reserved shared memory, so
// that the SM keeps 60 KB of L1 (the replica spectra, the twiddles)
static_assert(kBytes + 2048 <= 196 * 1024, "a block's shared memory");
}  // namespace wg

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's descriptor of the table's plane p, rows (k) 16 ks .. + 15, all
// its 64 columns, no swizzle
__device__ __forceinline__ uint64_t table_desc(uint32_t table, int p, int ks) {
  const uint32_t addr = table + p * (wg::kHalf / 8) * wg::kSbo + 2 * ks * wg::kLbo;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(wg::kLbo >> 4) << 16) |
         (static_cast<uint64_t>(wg::kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to v across the wgmma statements
// around it (wgmma reads and writes registers asynchronously)
__device__ __forceinline__ void fence_operand(float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t (&v)[wg::kKS][4]) {
#pragma unroll
  for (int i = 0; i < wg::kKS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(v[i][j])::"memory");
}

// d (+)= kScale a @ B on the warpgroup's m64n64k16 tile: a the thread's A
// fragment (bf16, registers), B the table at desc; d the accumulator
// fragment (float32), overwritten where accumulate is 0
template <int kScale>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kScale));
}

// re + j im = (a_re + j a_im) @ W on the table's 64 columns: re = Ar Wr -
// Ai Wi, im = Ar Wi + Ai Wr; or @ conj(W) (kConj): re = Ar Wr + Ai Wi, im =
// Ai Wr - Ar Wi; each product's sign on its A operand (scale-a). One wgmma
// group, waited for.
template <bool kConj>
__device__ __forceinline__ void complex_product(float (&re)[32], float (&im)[32],
                                                uint32_t (&a_re)[wg::kKS][4],
                                                uint32_t (&a_im)[wg::kKS][4], uint32_t tab) {
  fence_operand(a_re);
  fence_operand(a_im);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < wg::kKS; ++ks) {
    const uint64_t wr = table_desc(tab, 0, ks), wi = table_desc(tab, 1, ks);
    wgmma<1>(re, a_re[ks], wr, ks);
    wgmma<kConj ? 1 : -1>(re, a_im[ks], wi, 1);  // + Ai Wi, or - Ai Wi
    if constexpr (kConj) {  // im = Ai Wr - Ar Wi
      wgmma<1>(im, a_im[ks], wr, ks);
      wgmma<-1>(im, a_re[ks], wi, 1);
    } else {  // im = Ar Wi + Ai Wr
      wgmma<1>(im, a_re[ks], wi, ks);
      wgmma<1>(im, a_im[ks], wr, 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operand(re);
  fence_operand(im);
  fence_operand(a_re);
  fence_operand(a_im);
}

// bytes from device memory to shared memory with one bulk copy, completing
// on the mbarrier bar; every thread of the block returns once they are there
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(b)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  }
}

// The A fragments of bf16(P), P = Y * R_b, for every k-step: k-step ks
// takes P's columns 16 ks .. + 15, Y's n-tiles 2 ks and 2 ks + 1, whose
// accumulator fragments (rows gid, gid + 8, columns 2 tig, + 1 of each) are
// the A fragment's four words, low half the even column. Y from the warp's
// copy ys in fragment order, R_b from rb in the same order. kFlip negates
// the odd columns (k), which turns the table's columns n into n + 64.
// ys and rb point at the lane's first value.
template <bool kFlip>
__device__ __forceinline__ void p_fragments(uint32_t (&pr)[wg::kKS][4], uint32_t (&pi)[wg::kKS][4],
                                            const float4* ys, const float4* rb) {
  constexpr float s = kFlip ? -1.0f : 1.0f;
#pragma unroll
  for (int ks = 0; ks < wg::kKS; ++ks) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int nt = 2 * ks + t;
      const float4 yr = ys[(2 * nt) * 32];
      const float4 yi = ys[(2 * nt + 1) * 32];
      const float4 rr = __ldg(rb + (2 * nt) * 32);
      const float4 ri = __ldg(rb + (2 * nt + 1) * 32);
      pr[ks][2 * t] = pack_bf16(yr.x * rr.x - yi.x * ri.x, s * (yr.y * rr.y - yi.y * ri.y));
      pr[ks][2 * t + 1] = pack_bf16(yr.z * rr.z - yi.z * ri.z, s * (yr.w * rr.w - yi.w * ri.w));
      pi[ks][2 * t] = pack_bf16(yr.x * ri.x + yi.x * rr.x, s * (yr.y * ri.y + yi.y * rr.y));
      pi[ks][2 * t + 1] = pack_bf16(yr.z * ri.z + yi.z * rr.z, s * (yr.w * ri.w + yi.w * rr.w));
    }
  }
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// the column-exchange tile (16 rows x 32 columns a plane): (r, c) at
// r * 32 + (c ^ 8 (r & 3)), so that both the accumulator fragments' float2
// stores and a lane-per-column read are free of bank conflicts
__device__ __forceinline__ int exch_at(int r, int c) { return r * 32 + (c ^ (8 * (r & 3))); }

__global__ void __launch_bounds__(wg::kThreads, 1)
correlate_bf16_wgmma(const float* __restrict__ ar, const float* __restrict__ ai,
                     const float* __restrict__ br, const float* __restrict__ bi,
                     const float4* __restrict__ rep, const uint4* __restrict__ table,
                     const float2* __restrict__ tw, float* __restrict__ out_pow,
                     int* __restrict__ out_bin, int fpad, int s, int nb) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bulk_load(smem, table, kTableBytes, &bar);  // the only block-wide barrier
  const uint32_t tab = smem_u32(smem);

  unsigned char* base = smem + kTableBytes + warp * kWarpBytes;
  float4* ys = reinterpret_cast<float4*>(base);
  __nv_bfloat16* tre = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* tim = tre + kN1 * kLd;
  float* ure = reinterpret_cast<float*>(base + kSpec);
  float* uim = ure + kN1 * 32;
  const float2* twf = tw;              // [k1][m2]
  const float2* twi = tw + kN1 * kN2;  // [k1][n2]
  const int gid = lane >> 2;  // fragment row
  const int tig = lane & 3;   // fragment column pair

  const int groups = (fpad + kFrames - 1) / kFrames;
#pragma unroll 1
  for (int grp = blockIdx.x * kGroups + (warp >> 2); grp < groups; grp += gridDim.x * kGroups) {
    const int64_t f = static_cast<int64_t>(grp) * kFrames + (warp & 3);
    const bool live = f < fpad;

    // forward radix-16 DFT and twiddle into the A tile, then its fragments
    forward_columns<kN2>(ar + f * s, ai + f * s, br + f * s, bi + f * s, twf, tre, tim, kLd, s,
                         live, lane);
    __syncwarp();
    uint32_t are[kKS][4], aim[kKS][4];
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      load_a(are[ks], tre + 16 * ks, kLd, lane);
      load_a(aim[ks], tim + 16 * ks, kLd, lane);
    }
    __syncwarp();  // the tile is read: its place holds the spectrum

    // forward bulk DFT a half at a time, Y / N2 = B @ conj(W2c); the second
    // half (columns 64 and up) with B's odd columns negated. Y goes to the
    // warp's copy in fragment order, scaled by N2 (exact).
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      if (h == 1) {
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            are[ks][c] ^= 0x80000000u;  // exact
            aim[ks][c] ^= 0x80000000u;
          }
      }
      float yr[32], yi[32];
      complex_product<true>(yr, yi, are, aim, tab);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nt = 8 * h + j;
        const float n2 = static_cast<float>(kN2);
        ys[(2 * nt) * 32 + lane] =
            make_float4(n2 * yr[4 * j], n2 * yr[4 * j + 1], n2 * yr[4 * j + 2], n2 * yr[4 * j + 3]);
        ys[(2 * nt + 1) * 32 + lane] =
            make_float4(n2 * yi[4 * j], n2 * yi[4 * j + 1], n2 * yi[4 * j + 2], n2 * yi[4 * j + 3]);
      }
    }
    __syncwarp();
    // the warp's next frame into L2 while this group's inverse runs
    const int64_t fn = f + static_cast<int64_t>(gridDim.x) * kGroups * kFrames;
    if (fn < fpad) {
      for (int i = 32 * lane; i < s; i += 32 * 32) {
        prefetch_l2(ar + fn * s + i);
        prefetch_l2(ai + fn * s + i);
      }
      for (int i = 32 * lane; i < kN1 * kN2 - s; i += 32 * 32) {
        prefetch_l2(br + fn * s + i);
        prefetch_l2(bi + fn * s + i);
      }
    }

    // the inverse a half of the columns at a time, the bins inner: the
    // lane's columns n2 = 64 h + 32 c + lane (c = 0, 1) keep their running
    // max (strict >, so the lowest bin wins a tie) and bin (a byte) in
    // registers
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float best[2][kN1];
      uint32_t bins[2][kN1 / 4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int n1 = 0; n1 < kN1; ++n1) best[c][n1] = -1.0f;
#pragma unroll
        for (int i = 0; i < kN1 / 4; ++i) bins[c][i] = 0;
      }
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        uint32_t pr[kKS][4], pi[kKS][4];
        const float4* rb = rep + static_cast<int64_t>(b) * kRepBin + lane;
        if (h == 0) {
          p_fragments<false>(pr, pi, ys + lane, rb);
        } else {
          p_fragments<true>(pr, pi, ys + lane, rb);
        }
        float ur[32], ui[32];
        complex_product<false>(ur, ui, pr, pi, tab);
        // the next product's R_b into L1 while this one's DFTs run: one
        // 128-byte line a lane, the warpgroup's four warps the bin's 128
        const int next = b + 1 < nb ? b + 1 : 0;
        prefetch_l1(rep + static_cast<int64_t>(next) * kRepBin + 8 * (32 * (warp & 3) + lane));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // U's columns 32 c .. + 31 (n-tiles 4 c .. 4 c + 3) through the
          // exchange tile: the lane's column, twiddle, radix-16 inverse
          // DFT, power, running max
          __syncwarp();  // the tile's last readers are done
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = 4 * (4 * c + j), col = 8 * j + 2 * tig;
            *reinterpret_cast<float2*>(ure + exch_at(gid, col)) = make_float2(ur[o], ur[o + 1]);
            *reinterpret_cast<float2*>(ure + exch_at(gid + 8, col)) = make_float2(ur[o + 2], ur[o + 3]);
            *reinterpret_cast<float2*>(uim + exch_at(gid, col)) = make_float2(ui[o], ui[o + 1]);
            *reinterpret_cast<float2*>(uim + exch_at(gid + 8, col)) = make_float2(ui[o + 2], ui[o + 3]);
          }
          __syncwarp();
          const int n2 = 64 * h + 32 * c + lane;
          float2 v[kN1];
#pragma unroll
          for (int k1 = 0; k1 < kN1; ++k1) {
            const float u_r = ure[exch_at(k1, lane)];
            const float u_i = uim[exch_at(k1, lane)];
            const float2 t = __ldg(twi + k1 * kN2 + n2);
            v[k1] = make_float2(u_r * t.x - u_i * t.y, u_r * t.y + u_i * t.x);
          }
          float2 y[kN1];
          small_dft<true>(v, y, kN1 * kN1);
#pragma unroll
          for (int n1 = 0; n1 < kN1; ++n1) {
            const float p = y[n1].x * y[n1].x + y[n1].y * y[n1].y;
            if (p > best[c][n1]) {
              const int sh = 8 * (n1 & 3);
              best[c][n1] = p;
              bins[c][n1 >> 2] = (bins[c][n1 >> 2] & ~(0xffu << sh)) | (static_cast<uint32_t>(b) << sh);
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n2 = 64 * h + 32 * c + lane;
          float* op = out_pow + f * kN1 * kN2 + n2;
          int* ob = out_bin + f * kN1 * kN2 + n2;
#pragma unroll
          for (int n1 = 0; n1 < kN1; ++n1) {
            op[kN2 * n1] = best[c][n1];
            ob[kN2 * n1] = (bins[c][n1 >> 2] >> (8 * (n1 & 3))) & 0xff;
          }
        }
      }
    }
    __syncwarp();  // the spectrum is read: the next group's A tile goes there
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

// resident blocks an SM of the N = 2048 kernel (its shared memory), asked once
int wgmma_blocks_per_sm() {
  static int blocks = -1;
  if (blocks < 0) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, correlate_bf16_wgmma, wg::kThreads,
                                                      wg::kBytes) != cudaSuccess)
      return 0;
    blocks = b;
  }
  return blocks;
}

int set_smem(int log2n) {
  switch (log2n) {
    case 11:
      return static_cast<int>(cudaFuncSetAttribute(
          correlate_bf16_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kBytes));
    case 12:
      return static_cast<int>(cudaFuncSetAttribute(
          correlate_bf16_mma<256>, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<256>::kBytes));
    case 13:
      return static_cast<int>(cudaFuncSetAttribute(
          correlate_bf16_mma<512>, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<512>::kBytes));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// log2n in {11, 12, 13}: N = 2048, 4096 or 8192; 1 <= nb <= 256 and fpad >= 1
// (the wrapper checks them). rep: the replica spectra in fragment order;
// w2c: the bf16 bulk table W2c (wgmma's core-matrix layout at N = 2048, mma's
// fragment order otherwise); small: F1 and W1c rounded to bf16; tw: the
// forward and inverse twiddles (ops/acquire_cuda.py::bf16_tables,
// replica_table_bf16).
extern "C" int pm_correlate_bf16(const void* ar, const void* ai, const void* br, const void* bi,
                                 const void* rep, const void* w2c, const void* small,
                                 const void* tw, void* out_pow, void* out_bin, int fpad, int s,
                                 int nb, int log2n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = set_smem(log2n);
  if (err != 0) return err;
  err = static_cast<int>(cudaMemcpyToSymbolAsync(c_small, small, sizeof(c_small), 0,
                                                 cudaMemcpyDeviceToDevice, st));
  if (err != 0) return err;
  const float* a_r = static_cast<const float*>(ar);
  const float* a_i = static_cast<const float*>(ai);
  const float* b_r = static_cast<const float*>(br);
  const float* b_i = static_cast<const float*>(bi);
  const float4* r = static_cast<const float4*>(rep);
  const uint4* t = static_cast<const uint4*>(w2c);
  const float2* w = static_cast<const float2*>(tw);
  float* op = static_cast<float*>(out_pow);
  int* ob = static_cast<int*>(out_bin);
  if (log2n == 11) {
    int dev = 0, sms = 0;
    err = static_cast<int>(cudaGetDevice(&dev));
    if (err == 0) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (err != 0) return err;
    // persistent: at most the resident blocks of the card, each a walk over
    // groups of four frames, two warpgroups a block
    const int groups = (fpad + wg::kFrames - 1) / wg::kFrames;
    const int resident = sms * wgmma_blocks_per_sm();
    if (resident == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int need = (groups + wg::kGroups - 1) / wg::kGroups;
    const int blocks = need < resident ? need : resident;
    correlate_bf16_wgmma<<<blocks, wg::kThreads, wg::kBytes, st>>>(a_r, a_i, b_r, b_i, r, t, w, op,
                                                                   ob, fpad, s, nb);
  } else if (log2n == 12) {
    const int blocks = (fpad + Plan<256>::kWarps - 1) / Plan<256>::kWarps;
    correlate_bf16_mma<256><<<blocks, 32 * Plan<256>::kWarps, Plan<256>::kBytes, st>>>(
        a_r, a_i, b_r, b_i, r, t, w, op, ob, fpad, s, nb);
  } else {
    correlate_bf16_mma<512><<<fpad, 32, Plan<512>::kBytes, st>>>(a_r, a_i, b_r, b_i, r, t, w, op,
                                                                  ob, fpad, s, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resources for log2n (as pm_correlate_bf16): out[0] registers
// a thread, out[1] local memory (spill) bytes a thread, out[2] dynamic
// shared memory bytes a block, out[3] threads a block, out[4] resident
// blocks an SM, out[5] frames in flight an SM.
extern "C" int pm_correlate_bf16_resources(int log2n, int* out) {
  int err = set_smem(log2n);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  const void* fn;
  int threads, bytes, frames;
  if (log2n == 11) {
    fn = reinterpret_cast<const void*>(correlate_bf16_wgmma);
    threads = wg::kThreads, bytes = wg::kBytes, frames = wg::kGroups * wg::kFrames;
  } else if (log2n == 12) {
    fn = reinterpret_cast<const void*>(correlate_bf16_mma<256>);
    threads = 32 * Plan<256>::kWarps, bytes = Plan<256>::kBytes, frames = Plan<256>::kWarps;
  } else {
    fn = reinterpret_cast<const void*>(correlate_bf16_mma<512>);
    threads = 32 * Plan<512>::kWarps, bytes = Plan<512>::kBytes, frames = Plan<512>::kWarps;
  }
  err = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (err != 0) return err;
  int blocks = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, bytes));
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = bytes;
  out[3] = threads;
  out[4] = blocks;
  out[5] = blocks * frames;
  return 0;
}
