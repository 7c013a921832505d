// The payload pass's CRC check: from the corrected payload symbols of each
// detection to its payload bytes, the CRC-32 of its first n bytes and the
// CRC it carries in the 4 bytes after them (n = clamp(length, 0, max_len)).
//
// Replaces no TPU kernel. The JAX package checks the CRC in plain JAX
// (ops/crc.py::CrcEngine: the set bits' CRC words summed by an f32 GF(2)
// matmul), and the port first ran the same chain as ~67 PyTorch operations:
// scale, descramble, slice and pack the LLRs, then a gather of one CRC word
// per bit into an int64 [D, max_len, 8] tensor XOR-reduced by halving, 64
// bytes of intermediate per payload byte. At 4096-byte slots that gather
// moved 0.94 GB a step and the chain was the bank step's largest stage.
//
// Bound: device memory bandwidth, by the symbols read. A payload byte is 4
// complex64 symbols (32 bytes); a row reads the symbols of its own n + 4
// bytes and no more, and writes max_len payload bytes and two CRC words.
//
// Design. One block of 256 threads a row; a row's length is read on the
// card, so the grid is fixed by the shapes and the kernel can be captured
// into a CUDA graph. The CRC register is linear in the message, and leading
// zero bytes leave a zero register as it is, so the row's n bytes are laid
// right-aligned in a frame of `tiles` tiles of 4096 bytes; tiles before the
// message's first byte are skipped. For each tile:
//  - each thread slices a frame byte every 256 (consecutive threads,
//    consecutive 32-byte symbol groups: two 16-byte loads a thread), writes
//    it to the payload and to the tile in shared memory;
//  - each thread folds its own 16 bytes of the tile through the byte table
//    (in shared memory) from a zero register;
//  - the 256 registers are joined in a tree, inside each warp by shuffles
//    and across the 8 warps by warp 0: the left half's register is shifted
//    over the right half's length of zero bytes and XORed with the right
//    half's. A shift over 2^m zero bytes is a 32 x 32 GF(2) matrix built on
//    the host (ops/crc.py::zero_shift_matrices), read from shared memory at
//    one address across the warp;
//  - thread 0 shifts the running register over a tile and adds the tile's.
// The CRC engine's register from the initial value over n bytes
// (init_lut[n]) and its final XOR give the CRC. Warp 0's lanes 0-3 slice
// the 4 received CRC bytes; the payload's bytes from n on are written as
// zeros without reading the symbols under them. Bits are sliced with the float32 products of the
// plain chain (value times the LLR scale, compared with 0 after the
// keystream's sign flip), so zeros, negative zeros and NaNs slice as there.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // threads a block, one block a row
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 16;                // tile bytes a thread folds
constexpr int kTile = kThreads * kSpan;  // bytes a tile
constexpr int kLogSpan = 4;              // log2(kSpan)
constexpr int kShiftLevels = 13;         // Z^(2^m) for m < 13: up to a tile
// the tables, one uint32 array: the byte table, then the shift matrices
// (column i of matrix m at kShifts + 32 m + i)
constexpr int kShifts = 256;
constexpr int kTables = kShifts + 32 * kShiftLevels;

static_assert(kTile == 1 << (kShiftLevels - 1), "a tile is the largest shift");
static_assert(kSpan == 1 << kLogSpan, "kLogSpan");

// Z^(2^m)(r): the matrix m (32 columns) applied to r over GF(2).
__device__ __forceinline__ uint32_t shift(const uint32_t* m, uint32_t r) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) y ^= m[i] & (0u - ((r >> i) & 1u));
  return y;
}

// Payload byte i of a row: its 4 symbols' 8 LLRs (I then Q), MSB first,
// each bit (value * scale, negated where the keystream bit is 1) < 0.
__device__ __forceinline__ uint32_t slice_byte(const float4* __restrict__ row,
                                               int i, float scale,
                                               uint32_t ks) {
  const float4 a = row[2 * i];
  const float4 b = row[2 * i + 1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t byte = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float p = __fmul_rn(v[k], scale);
    const bool bit = ((ks >> (7 - k)) & 1u) ? p > 0.f : p < 0.f;
    byte |= static_cast<uint32_t>(bit) << (7 - k);
  }
  return byte;
}

__global__ void __launch_bounds__(kThreads)
    payload_crc_kernel(const float4* __restrict__ sym,
                       const float* __restrict__ llr_scale,
                       const uint8_t* __restrict__ ks,
                       const int64_t* __restrict__ plen,
                       const uint32_t* __restrict__ tables,
                       const int64_t* __restrict__ init_lut,
                       const int64_t* __restrict__ final_xor,
                       uint8_t* __restrict__ payload,
                       int64_t* __restrict__ words, int d, int max_len,
                       int tiles) {
  __shared__ uint32_t byte_table[256];
  __shared__ uint32_t shifts[32 * kShiftLevels];
  __shared__ __align__(16) uint8_t tile[kTile];
  __shared__ uint32_t warp_reg[kWarps];

  const int row = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int k = t; k < kTables; k += kThreads) {
    if (k < kShifts) {
      byte_table[k] = tables[k];
    } else {
      shifts[k - kShifts] = tables[k];
    }
  }
  const long long len = plen[row];
  const int n = len < 0 ? 0 : (len > max_len ? max_len : static_cast<int>(len));
  const float scale = *llr_scale;
  // a row is 4 (max_len + 4) symbols: 2 (max_len + 4) float4
  const float4* rs = sym + static_cast<size_t>(row) * 2 * (max_len + 4);
  uint8_t* out = payload + static_cast<size_t>(row) * max_len;

  // the received CRC: bytes n .. n + 3, big-endian, gathered in lane 0
  uint32_t crc_rx = 0;
  if (warp == 0) {
    if (lane < 4) crc_rx = slice_byte(rs, n + lane, scale, ks[n + lane]) << (24 - 8 * lane);
    crc_rx |= __shfl_down_sync(~0u, crc_rx, 2);
    crc_rx |= __shfl_down_sync(~0u, crc_rx, 1);
  }
  for (int i = n + t; i < max_len; i += kThreads) out[i] = 0;
  __syncthreads();  // the tables in shared memory

  const int lead = tiles * kTile - n;  // the frame's zero bytes before byte 0
  uint32_t acc = 0;                    // thread 0: the frame's register so far
  for (int k = lead / kTile; k < tiles; ++k) {
    const int base = k * kTile - lead;  // message index of the tile's byte 0
#pragma unroll 4
    for (int j = 0; j < kSpan; ++j) {
      const int q = j * kThreads + t;
      const int i = base + q;
      uint32_t b = 0;
      if (i >= 0) {
        b = slice_byte(rs, i, scale, ks[i]);
        out[i] = static_cast<uint8_t>(b);
      }
      tile[q] = static_cast<uint8_t>(b);
    }
    __syncthreads();
    // this thread's 16 bytes, folded from a zero register (the frame's zero
    // bytes keep it zero)
    const uint4 v = reinterpret_cast<const uint4*>(tile)[t];
    const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
    uint32_t r = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        r = byte_table[(r ^ (w4[w] >> (8 * s))) & 0xffu] ^ (r >> 8);
      }
    }
    if (__any_sync(~0u, r != 0)) {
#pragma unroll
      for (int l = 0; l < 5; ++l) {  // spans of 16 << l bytes on the right
        const uint32_t right = __shfl_down_sync(~0u, r, 1 << l);
        const uint32_t y = shift(shifts + 32 * (kLogSpan + l), r) ^ right;
        if ((lane & ((2 << l) - 1)) == 0) r = y;
      }
    }
    if (lane == 0) warp_reg[warp] = r;
    __syncthreads();
    if (warp == 0) {
      r = lane < kWarps ? warp_reg[lane] : 0;
#pragma unroll
      for (int l = 0; l < 3; ++l) {  // warps of 512 << l bytes on the right
        const uint32_t right = __shfl_down_sync(~0u, r, 1 << l);
        const uint32_t y = shift(shifts + 32 * (kLogSpan + 5 + l), r) ^ right;
        if ((lane & ((2 << l) - 1)) == 0) r = y;
      }
      if (lane == 0) acc = shift(shifts + 32 * (kShiftLevels - 1), acc) ^ r;
    }
  }
  if (t == 0) {
    words[row] = static_cast<int64_t>(acc ^ static_cast<uint32_t>(init_lut[n] ^ *final_xor));
    words[d + row] = static_cast<int64_t>(crc_rx);
  }
}

}  // namespace

extern "C" int pm_payload_crc(const void* sym, const void* llr_scale,
                              const void* ks, const void* plen,
                              const void* tables, const void* init_lut,
                              const void* final_xor, void* payload,
                              void* words, int d, int max_len, int tiles,
                              void* stream) {
  payload_crc_kernel<<<d, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(sym), static_cast<const float*>(llr_scale),
      static_cast<const uint8_t*>(ks), static_cast<const int64_t*>(plen),
      static_cast<const uint32_t*>(tables), static_cast<const int64_t*>(init_lut),
      static_cast<const int64_t*>(final_xor), static_cast<uint8_t*>(payload),
      static_cast<int64_t*>(words), d, max_len, tiles);
  return static_cast<int>(cudaGetLastError());
}
