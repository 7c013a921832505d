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
// At N = 4096 and 8192 (the bench bank: 10,240 and 5,120 frames) a frame is
// 84 and 336 MFLOP of bf16 tensor-core work (0.87 and 1.74 ms), the float32
// term 0.31 ms at both.
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
// Design at N = 4096 and 8192 (correlate_bf16_stream): the table (256 KB,
// 1 MB) and four frames' spectra (128 KB, 256 KB) do not fit in shared
// memory, so both products read both operands from shared memory
// (wgmma.m64n32k16, K-major core matrices, no swizzle) and the table is
// streamed. Persistent blocks of one warpgroup. W2c's first-half columns
// come in table blocks of 32 columns, each in chunks of 128 rows (16 KB,
// one cp.async.bulk each, completing on the chunk's full mbarrier) into
// as many shared-memory stages: once a product's wgmmas are done, thread 0
// starts the next product's block, so its copy overlaps this product's
// epilogue, and a product starts on its first chunk while the later ones
// arrive. (A producer warp feeding a finer ring through empty barriers
// was slower: its fifth warp cut the registers of two blocks an SM to 168
// at N = 4096, which spilled and serialized the wgmmas.) The rows k of the
// table and of every left operand are
// in the order k' (even k first, then odd), so that the second half of the
// columns, W2c[k][n + N2/2] = (-1)^k W2c[k][n] (the caveat above), is the
// same chunks with the odd half of k' negated by scale-a: each chunk feeds
// both halves' accumulators. The 64 rows of a product (wgmma's M) are four
// frames' B in the forward product, and four bins' P of one frame in the
// inverse: the four frames' spectra Y go to a scratch in device memory (a
// block's 128 or 256 KB, read back from L2), and each group of four bins
// rounds its P = Y * R_b to bf16 into shared memory once, for all its
// table blocks. A lane owns a column of U through the warp's exchange tile
// (twiddle, radix-16 inverse DFT, power); the four bins' powers meet in the
// tiles, and warp n1 / 4 keeps the first max with the earlier bin groups'
// in the outputs. A group of 9 bins runs as 12 (three groups of four).
// Shared memory: the A area (64 or 128 KB), a table block's stages (32 or
// 64 KB) and the exchange tiles (16 KB): two blocks an SM at N = 4096, one
// at 8192.
// No fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN1 = 16;    // the small radix

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

// ------------------------------- N = 4096, 8192: wgmma, the table streamed

namespace st {
constexpr int kRows = 64;        // a product's rows (wgmma's M): four frames or four bins
constexpr int kCols = 32;        // a table block's columns (wgmma's N)
constexpr int kChunkK = 128;     // rows (k') of a chunk of the table: eight k-steps
constexpr int kChunkSteps = kChunkK / 16;
constexpr int kLbo = 128;        // next 8 rows (k') of a core-matrix column
constexpr int kChunkSbo = kChunkK / 8 * 128;  // next 8 columns of a chunk
constexpr int kChunkPlane = kCols * kChunkK * 2;  // bytes of a chunk's part (re, im)
constexpr int kChunkBytes = 2 * kChunkPlane;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kFrames = 4;       // frames a group: the forward product's rows
constexpr int kExch = 2 * kN1 * 32 * 4;  // a warp's column-exchange tile
}  // namespace st

// The walk and the table's stages at N2 = 256 and 512 (the host's model:
// ops/acquire_cuda.py::stream_plan). The A area holds the product's left
// operand, 64 rows (m) x N2 (k') of bf16 a part, K-major core matrices:
// (m, k') at (m / 8) kASbo + (k' / 8) 128 + (m % 8) 16 + (k' % 8) 2. The
// stages hold a table block's kChunks chunks, 16 KB each.
template <int N2>
struct Stream {
  static constexpr int kKS = N2 / 16;                   // k-steps of a product
  static constexpr int kBlocks = N2 / 2 / st::kCols;    // table blocks: the first half's columns
  static constexpr int kChunks = N2 / st::kChunkK;      // chunks of a table block
  static constexpr int kMinBlocks = N2 == 256 ? 2 : 1;  // resident blocks an SM
  static constexpr int kASbo = N2 / 8 * 128;
  static constexpr int kAPlane = st::kRows * N2 * 2;
  static constexpr int kABytes = 2 * kAPlane;
  static constexpr int kStageBytes = kChunks * st::kChunkBytes;
  static constexpr int kBytes = kABytes + kStageBytes + 4 * st::kExch;
  static_assert(kChunks * st::kChunkK == N2 && kBlocks * st::kCols * 2 == N2, "the table's tiling");
  static_assert(kKS % (2 * st::kChunkSteps) == 0, "the odd half of k' starts at a chunk");
  static_assert(kBytes + 64 <= (kMinBlocks == 2 ? 115712 : 232448), "a block's shared memory");
};

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(st::kLbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (+)= kScale a @ b on the warpgroup's m64n32k16 tile, both operands from
// shared memory (descriptors), K-major, float32 accumulation
template <int kScale>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, %19, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(kScale));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_operand(float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// spins until the barrier completes its phase of this parity; the loop is
// inside the asm, so no branch of the compiler's lies between wgmmas
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a barrier of the block's one warpgroup
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(st::kThreads) : "memory");
}
// this thread's shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// k' of the natural row k (k2 or m2): the even rows first, then the odd ones,
// so that W2c[k][n + N2/2] = (-1)^k W2c[k][n] flips whole k-steps
template <int N2>
__device__ __forceinline__ int kprime(int k) {
  return (k & 1) * (N2 / 2) + (k >> 1);
}

// thread 0 (on) loads table block tb into the stages, one bulk copy a
// chunk completing on its full barrier (predicated, not branched)
template <int N2>
__device__ __forceinline__ void load_block(uint32_t stages, uint64_t* full,
                                           const unsigned char* table, int tb, bool on) {
  using S = Stream<N2>;
#pragma unroll
  for (int c = 0; c < S::kChunks; ++c) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %3;\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%2], %3, [%1];\n}\n"
        ::"r"(stages + c * st::kChunkBytes), "r"(smem_u32(&full[c])),
        "l"(table + static_cast<int64_t>(tb * S::kChunks + c) * st::kChunkBytes),
        "r"(st::kChunkBytes), "r"(static_cast<uint32_t>(on))
        : "memory");
  }
}

// The products on the chunks kc0 .. kc1 - 1 of the table block in the
// stages, their k' in the odd half (kOdd: the second half of the columns
// negated) or not
template <int N2, bool kConj, bool kOdd>
__device__ __forceinline__ void stream_chunks(float (&acc)[2][2][16], uint32_t a_area,
                                              uint32_t stages, uint64_t* full, uint32_t parity,
                                              int kc0, int kc1) {
  using S = Stream<N2>;
#pragma unroll 1
  for (int kc = kc0; kc < kc1; ++kc) {
    mbar_wait(&full[kc], parity);
    const uint32_t chunk = stages + kc * st::kChunkBytes;
    uint64_t ar = smem_desc(a_area + 256 * st::kChunkSteps * kc, S::kASbo);
    uint64_t wr = smem_desc(chunk, st::kChunkSbo);
    constexpr uint64_t kAi = S::kAPlane >> 4, kWi = st::kChunkPlane >> 4;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < st::kChunkSteps; ++j, ar += 16, wr += 16) {
      const uint64_t ai = ar + kAi, wi = wr + kWi;
      constexpr int s = kOdd ? -1 : 1;  // the second half's sign
      if constexpr (kConj) {  // re = Ar Wr + Ai Wi, im = Ai Wr - Ar Wi
        wgmma_ss<1>(acc[0][0], ar, wr);
        wgmma_ss<1>(acc[0][0], ai, wi);
        wgmma_ss<1>(acc[0][1], ai, wr);
        wgmma_ss<-1>(acc[0][1], ar, wi);
        wgmma_ss<s>(acc[1][0], ar, wr);
        wgmma_ss<s>(acc[1][0], ai, wi);
        wgmma_ss<s>(acc[1][1], ai, wr);
        wgmma_ss<-s>(acc[1][1], ar, wi);
      } else {  // re = Ar Wr - Ai Wi, im = Ar Wi + Ai Wr
        wgmma_ss<1>(acc[0][0], ar, wr);
        wgmma_ss<-1>(acc[0][0], ai, wi);
        wgmma_ss<1>(acc[0][1], ar, wi);
        wgmma_ss<1>(acc[0][1], ai, wr);
        wgmma_ss<s>(acc[1][0], ar, wr);
        wgmma_ss<-s>(acc[1][0], ai, wi);
        wgmma_ss<s>(acc[1][1], ar, wi);
        wgmma_ss<s>(acc[1][1], ai, wr);
      }
    }
    wgmma_commit();
  }
}

// One table block's product on the warpgroup: acc[h] = A @ W for the
// block's columns n (h = 0) and n + N2/2 (h = 1), the latter from the same
// chunks with the odd half of k' negated (scale-a); W = W2c, or conj(W2c)
// with kConj. A is the A area; the block is in the stages, the i-th
// product's (each stage's full barrier completes once a product). When
// its wgmmas are done, thread 0 starts the copy of table block next_tb
// for the next product where load is set.
template <int N2, bool kConj>
__device__ __forceinline__ void stream_product(float (&acc)[2][2][16], uint32_t a_area,
                                               uint32_t stages, uint64_t* full, uint32_t& i,
                                               const unsigned char* table, int next_tb, bool load) {
  using S = Stream<N2>;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int v = 0; v < 16; ++v) acc[h][p][v] = 0.0f;
  const uint32_t parity = i & 1;
  stream_chunks<N2, kConj, false>(acc, a_area, stages, full, parity, 0, S::kChunks / 2);
  stream_chunks<N2, kConj, true>(acc, a_area, stages, full, parity, S::kChunks / 2, S::kChunks);
  wgmma_wait<0>();
  warpgroup_sync();  // every warp's products are done: the stages are free
  load_block<N2>(stages, full, table, next_tb, load);
  ++i;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    fence_operand(acc[h][0]);
    fence_operand(acc[h][1]);
  }
}

// The forward radix-16 DFT and twiddle of the warp's frame, rounded to bf16
// into rows 16 warp .. + 15 of the A area (column m2 at k' = kprime(m2)); a
// frame that does not exist (live false) is zeros
template <int N2>
__device__ __forceinline__ void forward_rows(const float* fa_r, const float* fa_i,
                                             const float* fb_r, const float* fb_i,
                                             const float2* twf, unsigned char* a_area, int s,
                                             bool live, int warp, int lane) {
  using S = Stream<N2>;
#pragma unroll 1
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
    const int kp = kprime<N2>(m2);
    unsigned char* col = a_area + (kp >> 3) * 128 + (kp & 7) * 2;
#pragma unroll
    for (int k1 = 0; k1 < kN1; ++k1) {
      const float2 t = __ldg(twf + k1 * N2 + m2);
      const int m = 16 * warp + k1;
      unsigned char* q = col + (m >> 3) * S::kASbo + (m & 7) * 16;
      *reinterpret_cast<__nv_bfloat16*>(q) = __float2bfloat16_rn(a[k1].x * t.x - a[k1].y * t.y);
      *reinterpret_cast<__nv_bfloat16*>(q + S::kAPlane) =
          __float2bfloat16_rn(a[k1].x * t.y + a[k1].y * t.x);
    }
  }
}

// bf16(P), P = Y * R_b, for the warp's bin into rows 16 warp .. + 15 of the
// A area: y and r the frame's spectrum and the bin's replica, [16][N2]
// complex in k' order. Lane (row, og) writes a core matrix's row of 8 k' a
// part at a time: a quarter-warp's eight rows are 128 contiguous bytes.
template <int N2>
__device__ __forceinline__ void p_rows(unsigned char* a_area, const float2* y, const float2* r,
                                       int warp, int lane) {
  using S = Stream<N2>;
  const int row = lane & 7, og = lane >> 3;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int k1 = 8 * half + row;
    const float4* yp = reinterpret_cast<const float4*>(y + k1 * N2);
    const float4* rp = reinterpret_cast<const float4*>(r + k1 * N2);
    unsigned char* dst = a_area + (2 * warp + half) * S::kASbo + row * 16;
#pragma unroll 4
    for (int o = og; o < N2 / 8; o += 4) {
      uint32_t wr[4], wi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 yv = __ldcg(yp + 4 * o + q);  // written by this kernel: not through L1
        const float4 rv = __ldg(rp + 4 * o + q);
        wr[q] = pack_bf16(yv.x * rv.x - yv.y * rv.y, yv.z * rv.z - yv.w * rv.w);
        wi[q] = pack_bf16(yv.x * rv.y + yv.y * rv.x, yv.z * rv.w + yv.w * rv.z);
      }
      *reinterpret_cast<uint4*>(dst + o * 128) = make_uint4(wr[0], wr[1], wr[2], wr[3]);
      *reinterpret_cast<uint4*>(dst + S::kAPlane + o * 128) = make_uint4(wi[0], wi[1], wi[2], wi[3]);
    }
  }
}

// Persistent blocks of one warpgroup, each a walk over groups of four
// frames (group g, g + gridDim.x, ...); every pass of products sweeps the
// table blocks in order, so the next product's block is always the next
// one, modulo their number:
// - forward: warp w's radix-16 DFT of frame 4 g + w into the A area, then
//   for each table block Y / N2 = B @ conj(W2c) (both halves of the
//   columns), Y scaled by N2 (exact) into the block's scratch, [frame][k1]
//   [k'] complex;
// - inverse, for each frame of the group and each group of four bins: warp
//   w's bf16(Y * R_b) for bin 4 bg + w into the A area, then for each table
//   block U = P @ W2c, each warp's U through its exchange tile so that a
//   lane owns a column (twiddle, radix-16 inverse DFT, power), the four
//   bins' powers through the tiles again to warp n1 / 4, which keeps the
//   first max (strict >, bins in order) with the earlier groups' result in
//   the outputs.
template <int N2>
__global__ void __launch_bounds__(st::kThreads, Stream<N2>::kMinBlocks)
correlate_bf16_stream(const float* __restrict__ ar, const float* __restrict__ ai,
                      const float* __restrict__ br, const float* __restrict__ bi,
                      const float2* __restrict__ rep, const unsigned char* __restrict__ table,
                      const float2* __restrict__ tw, float2* __restrict__ scratch,
                      float* __restrict__ out_pow, int* __restrict__ out_bin, int fpad, int s,
                      int nb) {
  using S = Stream<N2>;
  constexpr int kN = kN1 * N2;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S::kChunks];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* stages = smem + S::kABytes;
  const int groups = (fpad + st::kFrames - 1) / st::kFrames;
  const int nbg = (nb + 3) / 4;
  if (threadIdx.x == 0) {
    for (int k = 0; k < S::kChunks; ++k) mbar_init(&full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  load_block<N2>(smem_u32(stages), full, table, 0, threadIdx.x == 0);

  const uint32_t a_area = smem_u32(smem);
  const uint32_t stages_u32 = smem_u32(stages);
  float* ure = reinterpret_cast<float*>(stages + S::kStageBytes + warp * st::kExch);
  float* uim = ure + kN1 * 32;
  float2* ys = scratch + static_cast<int64_t>(blockIdx.x) * st::kFrames * kN1 * N2;
  const float2* twf = tw;              // [k1][m2]
  const float2* twi = tw + kN1 * N2;   // [k1][n2]
  const int gid = lane >> 2;  // fragment row
  const int tig = lane & 3;   // fragment column pair
  uint32_t i = 0;             // the products so far

#pragma unroll 1
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t f0 = static_cast<int64_t>(grp) * st::kFrames;
    const int live = fpad - f0 < st::kFrames ? static_cast<int>(fpad - f0) : st::kFrames;
    const bool last_group = grp + static_cast<int>(gridDim.x) >= groups;
    {
      const int64_t f = f0 + warp;
      forward_rows<N2>(ar + f * s, ai + f * s, br + f * s, bi + f * s, twf, smem, s, warp < live,
                       warp, lane);
    }
    fence_async_shared();
    warpgroup_sync();

    // forward bulk DFT, a table block at a time: the warp's frame's rows
    // gid, gid + 8 and columns n = 32 tb + 8 j + 2 tig (+1), + N2/2 (h = 1)
#pragma unroll 1
    for (int tb = 0; tb < S::kBlocks; ++tb) {
      float acc[2][2][16];
      stream_product<N2, true>(acc, a_area, stages_u32, full, i, table, (tb + 1) % S::kBlocks,
                               threadIdx.x == 0);
      float2* yw = ys + warp * kN1 * N2;
      const float n2f = static_cast<float>(N2);  // exact
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 16; ++v) {
          const int row = gid + 8 * ((v >> 1) & 1);
          const int n = st::kCols * tb + 8 * (v >> 2) + 2 * tig + (v & 1) + h * (N2 / 2);
          __stcg(yw + row * N2 + kprime<N2>(n), make_float2(n2f * acc[h][0][v], n2f * acc[h][1][v]));
        }
    }
    warpgroup_sync();  // Y is written; the A area is free

    // inverse, a frame of the group and four bins at a time
#pragma unroll 1
    for (int fr = 0; fr < live; ++fr) {
      const int64_t f = f0 + fr;
#pragma unroll 1
      for (int bg = 0; bg < nbg; ++bg) {
        const int b = 4 * bg + warp;
        if (b < nb) p_rows<N2>(smem, ys + fr * kN1 * N2, rep + static_cast<int64_t>(b) * kN1 * N2, warp, lane);
        fence_async_shared();
        warpgroup_sync();
#pragma unroll 1
        for (int tb = 0; tb < S::kBlocks; ++tb) {
          float acc[2][2][16];
          const bool more = !(last_group && fr == live - 1 && bg == nbg - 1 && tb == S::kBlocks - 1);
          stream_product<N2, false>(acc, a_area, stages_u32, full, i, table, (tb + 1) % S::kBlocks,
                                    more && threadIdx.x == 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // the lane's column n2 and the earlier bin groups' result for
            // rows 4 warp .. + 3, loaded while U is exchanged and transformed
            const int n2 = st::kCols * tb + lane + h * (N2 / 2);
            float old_p[4];
            int old_b[4];
            if (bg > 0) {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int64_t at = f * kN + N2 * (4 * warp + r) + n2;
                old_p[r] = __ldcg(out_pow + at);
                old_b[r] = __ldcg(out_bin + at);
              }
            }
            // the warp's U [16, 32] through its exchange tile
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int o = 4 * j, col = 8 * j + 2 * tig;
              *reinterpret_cast<float2*>(ure + exch_at(gid, col)) = make_float2(acc[h][0][o], acc[h][0][o + 1]);
              *reinterpret_cast<float2*>(ure + exch_at(gid + 8, col)) = make_float2(acc[h][0][o + 2], acc[h][0][o + 3]);
              *reinterpret_cast<float2*>(uim + exch_at(gid, col)) = make_float2(acc[h][1][o], acc[h][1][o + 1]);
              *reinterpret_cast<float2*>(uim + exch_at(gid + 8, col)) = make_float2(acc[h][1][o + 2], acc[h][1][o + 3]);
            }
            __syncwarp();
            // the lane's column: twiddle, radix-16 inverse DFT, power
            float2 v[kN1];
#pragma unroll
            for (int k1 = 0; k1 < kN1; ++k1) {
              const float u_r = ure[exch_at(k1, lane)];
              const float u_i = uim[exch_at(k1, lane)];
              const float2 t = __ldg(twi + k1 * N2 + n2);
              v[k1] = make_float2(u_r * t.x - u_i * t.y, u_r * t.y + u_i * t.x);
            }
            float2 y[kN1];
            small_dft<true>(v, y, kN1 * kN1);
            __syncwarp();  // the tile is read: the powers go there
#pragma unroll
            for (int n1 = 0; n1 < kN1; ++n1) ure[n1 * 32 + lane] = y[n1].x * y[n1].x + y[n1].y * y[n1].y;
            warpgroup_sync();
            // rows n1 = 4 warp .. + 3: the first max over the group's bins,
            // then with the earlier groups' in the outputs
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int n1 = 4 * warp + r;
              float best = -1.0f;
              int bin = 0;
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                const float* pw = reinterpret_cast<const float*>(stages + S::kStageBytes + w * st::kExch);
                const float p = pw[n1 * 32 + lane];
                if (4 * bg + w < nb && p > best) {
                  best = p;
                  bin = 4 * bg + w;
                }
              }
              const int64_t at = f * kN + N2 * n1 + n2;
              if (bg > 0 && !(best > old_p[r])) {
                best = old_p[r];
                bin = old_b[r];
              }
              __stcg(out_pow + at, best);
              __stcg(out_bin + at, bin);
            }
            warpgroup_sync();  // the tiles are read: the next U goes there
          }
        }
      }
    }
  }
}

// Each size's kernel, its threads, dynamic shared memory, frames a block
// in flight, and its resident blocks an SM (asked once)
struct Launch {
  const void* fn;
  int threads, bytes, frames;
};

Launch launch_of(int log2n) {
  switch (log2n) {
    case 11:
      return {reinterpret_cast<const void*>(correlate_bf16_wgmma), wg::kThreads, wg::kBytes,
              wg::kGroups * wg::kFrames};
    case 12:
      return {reinterpret_cast<const void*>(correlate_bf16_stream<256>), st::kThreads,
              Stream<256>::kBytes, st::kFrames};
    case 13:
      return {reinterpret_cast<const void*>(correlate_bf16_stream<512>), st::kThreads,
              Stream<512>::kBytes, st::kFrames};
    default:
      return {nullptr, 0, 0, 0};
  }
}

int set_smem(const Launch& l) {
  if (l.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes));
}

int blocks_per_sm(int log2n, const Launch& l, int* out) {
  static int cached[3] = {-1, -1, -1};
  int& c = cached[log2n - 11];
  if (c < 0) {
    int err = set_smem(l);
    if (err == 0)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c, l.fn, l.threads, l.bytes));
    if (err != 0) {
      c = -1;
      return err;
    }
  }
  *out = c;
  return 0;
}

}  // namespace

// log2n in {11, 12, 13}: N = 2048, 4096 or 8192; 1 <= nb <= 256 and fpad >= 1
// (the wrapper checks them). rep: the replica spectra (the accumulator's
// fragment order at N = 2048, [nb][16][N2] complex in k' order otherwise);
// w2c: the bf16 bulk table in the kernel's layout; small: F1 and W1c rounded
// to bf16; tw: the forward and inverse twiddles
// (ops/acquire_cuda.py::bf16_tables, replica_table_bf16). At N = 4096 and
// 8192 scratch holds the spectra of the groups in flight, four frames of
// [16][N2] complex a block, for at most scratch_blocks blocks.
extern "C" int pm_correlate_bf16(const void* ar, const void* ai, const void* br, const void* bi,
                                 const void* rep, const void* w2c, const void* small,
                                 const void* tw, void* scratch, void* out_pow, void* out_bin,
                                 int fpad, int s, int nb, int log2n, int scratch_blocks,
                                 void* stream) {
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const Launch l = launch_of(log2n);
  int per_sm = 0;
  int err = l.fn == nullptr ? static_cast<int>(cudaErrorInvalidValue) : blocks_per_sm(log2n, l, &per_sm);
  if (err != 0) return err;
  err = set_smem(l);
  if (err != 0) return err;
  err = static_cast<int>(cudaMemcpyToSymbolAsync(c_small, small, sizeof(c_small), 0,
                                                 cudaMemcpyDeviceToDevice, st_));
  if (err != 0) return err;
  int dev = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  const int resident = sms * per_sm;
  if (resident == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* a_r = static_cast<const float*>(ar);
  const float* a_i = static_cast<const float*>(ai);
  const float* b_r = static_cast<const float*>(br);
  const float* b_i = static_cast<const float*>(bi);
  const float2* w = static_cast<const float2*>(tw);
  float* op = static_cast<float*>(out_pow);
  int* ob = static_cast<int*>(out_bin);
  if (log2n == 11) {
    // persistent: at most the resident blocks of the card, each a walk over
    // groups of four frames, two warpgroups a block
    const int groups = (fpad + wg::kFrames - 1) / wg::kFrames;
    const int need = (groups + wg::kGroups - 1) / wg::kGroups;
    const int blocks = need < resident ? need : resident;
    correlate_bf16_wgmma<<<blocks, wg::kThreads, wg::kBytes, st_>>>(
        a_r, a_i, b_r, b_i, static_cast<const float4*>(rep), static_cast<const uint4*>(w2c), w, op,
        ob, fpad, s, nb);
  } else {
    // persistent: a block a group of four frames at a time, at most the
    // resident blocks and the blocks the scratch holds
    const int groups = (fpad + st::kFrames - 1) / st::kFrames;
    int blocks = groups < resident ? groups : resident;
    if (scratch_blocks < blocks) blocks = scratch_blocks;
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    const float2* r = static_cast<const float2*>(rep);
    const unsigned char* t = static_cast<const unsigned char*>(w2c);
    float2* y = static_cast<float2*>(scratch);
    if (log2n == 12) {
      correlate_bf16_stream<256><<<blocks, st::kThreads, Stream<256>::kBytes, st_>>>(
          a_r, a_i, b_r, b_i, r, t, w, y, op, ob, fpad, s, nb);
    } else {
      correlate_bf16_stream<512><<<blocks, st::kThreads, Stream<512>::kBytes, st_>>>(
          a_r, a_i, b_r, b_i, r, t, w, y, op, ob, fpad, s, nb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resources for log2n (as pm_correlate_bf16): out[0] registers
// a thread, out[1] local memory (spill) bytes a thread, out[2] dynamic
// shared memory bytes a block, out[3] threads a block, out[4] resident
// blocks an SM, out[5] frames in flight an SM.
extern "C" int pm_correlate_bf16_resources(int log2n, int* out) {
  const Launch l = launch_of(log2n);
  if (l.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  int err = blocks_per_sm(log2n, l, &blocks);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, l.fn));
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = l.bytes;
  out[3] = l.threads;
  out[4] = blocks;
  out[5] = blocks * l.frames;
  return 0;
}
