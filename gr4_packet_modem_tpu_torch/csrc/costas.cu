// K4 Costas loop: the exact per-packet carrier-recovery recursion over the
// receiver's positional schedule (costas_step.cuh), from packet symbol
// `offset` on, for the rows a per-row mask marks active.
//
// Replaces gr4_packet_modem_tpu/ops/costas_pallas.py::costas_track_pallas
// (kernel _make_kernel). The TPU kernel advanced 1024 packets per step in one
// [8, 128] vector tile and carried the state across symbol blocks in scratch
// memory; here each packet is one thread and the whole recursion runs in its
// registers.
//
// Bound: the latency of the sequential dependency chain (cosf/sinf and
// about 15 dependent operations per symbol), not the 16 bytes a symbol
// moves nor its arithmetic. So nothing else may sit on that chain: a load
// from device memory issued in the step that needs it costs several hundred
// cycles. Design: one warp per 32 packets, reading the [B, S] symbols as
// they lie. The warp stages tiles of 32 symbols x 32 packets in shared
// memory with cp.async, kStages tiles in a ring, so the tiles after the
// one being stepped through are in flight while it runs; each row of a
// tile is one coalesced 256-byte read. A thread steps through its packet's
// row (rows padded by one symbol: the 32 threads' reads of one column hit
// distinct banks), writes each corrected symbol over its input, and the
// warp writes the tile back to the [B, S] output, coalesced along S. Ragged
// edges (B not a multiple of 32, S not a multiple of 32) are masked; the
// schedule's switch points fall anywhere in a tile.
//
// The mask (`active`, one byte a row; null: every row active) is the
// detection's valid flag. A slot with no detection reaches K4 scaled by
// about 1e9 (its amplitude is 0), its loop error is then about 1e9 and its
// phase runs away past the one 2 pi wrap a step; cosf/sinf of |x| above
// ~1e5 take the slow Payne-Hanek reduction on every later symbol, and a
// warp waits for its slowest lane. So an inactive row steps no symbol: its
// output row is zeros and its end state its start state. A warp with no
// active row writes its zeros and stages no tile; in a warp with some, the
// inactive rows' tiles are still staged, and their lanes write zeros into
// them in place of stepping. Active rows run the same step as without a
// mask, bit for bit. Each warp adds its count of inactive rows, one atomic
// add, to `skipped` (a device counter; null: not counted).
#include <cuda_runtime.h>
#include <stdint.h>

#include "costas_step.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 32;       // symbols a tile: one per lane in the copies
constexpr int kStages = 4;      // tiles in the ring
constexpr int kRow = kTile + 1;  // padded row, in float2

using Tile = float2[kWarp][kRow];

__device__ __forceinline__ void copy_async(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, rows) of the warp's packets, symbols [i0, i0 + cols): lane l
// copies column l of every row.
__device__ __forceinline__ void load_tile(Tile& t, const float2* sym,
                                          int64_t row0, int rows, int64_t s,
                                          int i0, int cols, int lane) {
  if (lane >= cols) return;
#pragma unroll 8
  for (int r = 0; r < rows; ++r)
    copy_async(&t[r][lane], sym + (row0 + r) * s + i0 + lane);
}

__device__ __forceinline__ void store_tile(const Tile& t, float2* out,
                                           int64_t row0, int rows, int64_t s,
                                           int i0, int cols, int lane) {
  if (lane >= cols) return;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) out[(row0 + r) * s + i0 + lane] = t[r][lane];
}

// Zeros over rows [0, rows) of the warp's packets, every symbol: lane l
// writes columns l, l + 32, ..., coalesced along S.
__device__ __forceinline__ void store_zeros(float2* out, int64_t row0, int rows, int64_t s,
                                            int lane) {
  const float2 zero = make_float2(0.0f, 0.0f);
  for (int r = 0; r < rows; ++r)
    for (int64_t i = lane; i < s; i += kWarp) out[(row0 + r) * s + i] = zero;
}

__global__ void __launch_bounds__(kWarp)
    costas_kernel(const float2* __restrict__ sym, float2* __restrict__ out,
                  const float* __restrict__ ph0, const float* __restrict__ fr0,
                  float* __restrict__ ph_end, float* __restrict__ fr_end,
                  const uint8_t* __restrict__ active,
                  unsigned long long* __restrict__ skipped, int b, int s, int offset) {
  __shared__ __align__(16) Tile ring[kStages];
  const int lane = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kWarp;
  const int rows = min(kWarp, static_cast<int>(b - row0));
  const bool mine = lane < rows;
  const bool live = mine && (active == nullptr || active[row0 + lane] != 0);
  const unsigned idle = __ballot_sync(0xffffffffu, mine && !live);
  float ph = mine ? ph0[row0 + lane] : 0.0f;
  float fr = mine ? fr0[row0 + lane] : 0.0f;
  if (skipped != nullptr && lane == 0 && idle != 0u)
    atomicAdd(skipped, static_cast<unsigned long long>(__popc(idle)));
  if (__popc(idle) == rows) {  // no active row: zeros, and the state as it came
    store_zeros(out, row0, rows, s, lane);
    if (mine) {
      ph_end[row0 + lane] = ph;
      fr_end[row0 + lane] = fr;
    }
    return;
  }
  const int tiles = (s + kTile - 1) / kTile;
  // one commit group per tile, empty past the end, so that waiting for
  // all but the kStages - 1 newest groups always means "this tile is in"
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < tiles)
      load_tile(ring[t], sym, row0, rows, s, t * kTile, min(kTile, s - t * kTile), lane);
    commit();
  }
  for (int t = 0; t < tiles; ++t) {
    Tile& buf = ring[t % kStages];
    const int i0 = t * kTile;
    const int cols = min(kTile, s - i0);
    wait_pending<kStages - 1>();
    __syncwarp();
    if (live) {
      for (int j = 0; j < cols; ++j)
        buf[lane][j] = pm_costas::step(buf[lane][j], offset + i0 + j, ph, fr);
    } else if (mine) {
      for (int j = 0; j < cols; ++j) buf[lane][j] = make_float2(0.0f, 0.0f);
    }
    __syncwarp();
    store_tile(buf, out, row0, rows, s, i0, cols, lane);
    __syncwarp();
    const int next = t + kStages;
    if (next < tiles)
      load_tile(buf, sym, row0, rows, s, next * kTile, min(kTile, s - next * kTile), lane);
    commit();
  }
  if (mine) {
    ph_end[row0 + lane] = ph;
    fr_end[row0 + lane] = fr;
  }
}

}  // namespace

extern "C" int pm_costas_track(const void* sym, void* out, const void* ph0,
                               const void* fr0, void* ph_end, void* fr_end,
                               const void* active, void* skipped, int b, int s,
                               int offset, void* stream) {
  // one warp a block: B = 1536 packets spread over 48 SMs, each chain
  // alone on its scheduler
  costas_kernel<<<(b + kWarp - 1) / kWarp, kWarp, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(sym), static_cast<float2*>(out),
      static_cast<const float*>(ph0), static_cast<const float*>(fr0),
      static_cast<float*>(ph_end), static_cast<float*>(fr_end),
      static_cast<const uint8_t*>(active), static_cast<unsigned long long*>(skipped), b, s,
      offset);
  return static_cast<int>(cudaGetLastError());
}
