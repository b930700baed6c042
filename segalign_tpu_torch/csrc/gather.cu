// K2 and K3: (B,) window starts -> (B, W) byte windows of a padded sequence.
//
// K2 replaces segalign_tpu/ops/extend_pallas.py gather_rows_pallas
// (_gather_rows_kernel); K3 replaces gather_rows_qtile
// (_gather_qtile_kernel). Both compute out[i, k] = seq[s_i + k] with s_i
// the start clamped to [0, L - W], so no start can address past the
// sequence. The output is uint8: the values equal the TPU kernels' int32
// at a quarter of the bytes.
//
// Bound on the H100: bytes moved, B x W written, the sequence's bytes read
// once (the windows overlap: a 4 Mbp sequence is 4.2 MB) and 4 bytes a
// start: at the main path's shapes (B = 2^17, W = 1024 and 2048) 138.7 MB
// and 273.0 MB, 0.041 ms and 0.081 ms at 3.35 TB/s; no arithmetic. The TPU
// kernels pay a fixed cost per row DMA (aligned supersets, rolls); here a
// row is a contiguous read. K2 covers it in 128-byte pieces, 4 bytes a
// thread, and writes aligned 32-bit words.
//
// K3 serves tiles of 128 rows whose windows cluster (query-sorted hits,
// tandem-dense reference blocks). What it moves beside the B x W bytes it
// writes: each tile's span once from L2 into shared memory (8 KB a tile at
// T = 64 for 128 KB written; up to 61 KB at T = 512), not W bytes a row. A
// grid of resident blocks walks the tiles with two stages of shared memory:
//
//   plan     warps 0-3 clamp the tile's 128 starts and reduce their least
//            and greatest (__reduce_min_sync / __reduce_max_sync, one
//            shared word a warp, no atomics);
//   stage    one thread asks for the span as one bulk copy (the TMA's
//            linear form) that completes on the stage's mbarrier. The span
//            is rounded to 16 bytes on the absolute address, clipped to the
//            aligned bytes the sequence really holds, and capped at
//            min(T x 128, 96 KB), so that two stages fit a block at every
//            T the wrapper admits. The copy of tile t + 1 is in flight
//            while tile t is cut;
//   cut      a warp takes a row: once a row its offset into the stage, then
//            16 output bytes a thread from two aligned 16-byte shared words
//            and a funnel shift (cut16), stored as one uint4.
//
// A row whose window does not lie inside the staged bytes (the cap, the
// clipped ends, a sequence whose address is not a multiple of 16) reads
// global memory in the same form: two aligned 16-byte loads where they lie
// inside the sequence, single bytes at its ends. So the output never
// depends on how the rows cluster or where the sequence lies. W that is
// not a multiple of 16 takes the same two routes in 4-byte words.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;        // K2 rows per block
constexpr int kTileRows = 128;          // K3 rows per tile
constexpr int kPlanWarps = kTileRows / 32;
constexpr int kMaxT = 1024;             // the wrapper's limit
constexpr int kMaxStage = 96 * 1024;    // staged bytes a stage, at most
constexpr int kStagePad = 16;   // cut16 reads one 16-byte word past a row
constexpr int kMaxDevices = 64;  // launch parameters are kept a device

__device__ __forceinline__ int64_t clamp_start(int32_t s, int64_t hi) {
  const int64_t v = s;
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

__global__ void gather_rows_kernel(const uint8_t* __restrict__ seq,
                                   int64_t L, const int32_t* __restrict__ starts,
                                   int B, int W, uint32_t* __restrict__ out) {
  const int words = W / 4;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int nrows = B - row0 < kRowsPerBlock ? B - row0 : kRowsPerBlock;
  for (int i = threadIdx.x; i < nrows * words; i += blockDim.x) {
    const int row = row0 + i / words, w = i % words;
    const int64_t s = clamp_start(starts[row], L - W);
    out[static_cast<size_t>(row) * words + w] = load4(seq + s + 4 * w);
  }
}

// ---- K3. Positions are counted from the 16-byte boundary at or below the
// sequence's address: x = (offset in seq) + m with m = address % 16, so that
// x % 16 == 0 is an aligned address and the sequence lies at [m, m + L).

// The staged bytes of a tile, [a, a + n) in x.
struct Span {
  int64_t a;
  int n;
};

__device__ __forceinline__ Span tile_span(const uint32_t* wlo,
                                          const uint32_t* whi, int W, int m,
                                          int64_t L, int cap) {
  uint32_t lo = wlo[0], hi = whi[0];
#pragma unroll
  for (int k = 1; k < kPlanWarps; ++k) {
    lo = min(lo, wlo[k]);
    hi = max(hi, whi[k]);
  }
  int64_t a = (static_cast<int64_t>(lo) + m) & ~int64_t{15};
  const int64_t first = (m + 15) & ~15;           // aligned and >= m
  if (a < first) a = first;
  int64_t b = (static_cast<int64_t>(hi) + W + m + 15) & ~int64_t{15};
  const int64_t last = (L + m) & ~int64_t{15};    // aligned and <= m + L
  if (b > last) b = last;
  const int64_t n = b - a;
  return Span{a, static_cast<int>(n < 0 ? 0 : (n > cap ? cap : n))};
}

// The 16 bytes at offset p of the sequence, from global memory.
__device__ __forceinline__ uint4 direct16(const uint8_t* __restrict__ seq,
                                          int64_t L, int64_t p, int m) {
  const int64_t x = p + m, x0 = x & ~int64_t{15};
  const int off = static_cast<int>(x & 15);
  if (x0 >= m && x0 + (off ? 32 : 16) <= m + L) {
    const uint4* g = reinterpret_cast<const uint4*>(seq - m + x0);
    const uint4 lo = __ldg(g);
    return sa::cut16(lo, off ? __ldg(g + 1) : lo, off);
  }
  // an aligned word would reach past an end of the sequence
  return make_uint4(load4(seq + p), load4(seq + p + 4), load4(seq + p + 8),
                    load4(seq + p + 12));
}

__global__ void __launch_bounds__(1024)
    gather_rows_tile_kernel(const uint8_t* __restrict__ seq, int64_t L,
                            const int32_t* __restrict__ starts, int B, int W,
                            int cap, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t stages[];   // 2 x (cap + pad)
  __shared__ uint32_t s_row[2][kTileRows];   // clamped starts (below 2^31)
  __shared__ uint32_t wlo[2][kPlanWarps], whi[2][kPlanWarps];
  __shared__ __align__(8) uint64_t full[2];  // a stage's copy has landed
  const int m =
      static_cast<int>(reinterpret_cast<uintptr_t>(seq) & uintptr_t{15});
  const int ntiles = (B + kTileRows - 1) / kTileRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool wide = W % 16 == 0;

  // warps 0-3 hold a start a thread: a tile's starts are read one step
  // before they are planned, so that the read's latency hides behind a cut
  auto fetch = [&](int tile) -> int32_t {
    const int row = tile * kTileRows + threadIdx.x;
    return warp < kPlanWarps && tile < ntiles && row < B ? starts[row] : 0;
  };
  // warps 0-3: the tile's clamped starts, and their ends a warp
  auto plan = [&](int tile, int st, int32_t raw) {
    if (warp >= kPlanWarps) return;
    uint32_t lo = 0xffffffffu, hi = 0;
    if (tile * kTileRows + threadIdx.x < B) {
      lo = hi = static_cast<uint32_t>(clamp_start(raw, L - W));
      s_row[st][threadIdx.x] = lo;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      wlo[st][warp] = lo;
      whi[st][warp] = hi;
    }
  };
  // thread 0, after the barrier that follows plan: start the span's copy
  auto stage = [&](int st) {
    const Span sp = tile_span(wlo[st], whi[st], W, m, L, cap);
    sa::mbar_arrive_expect(&full[st], sp.n);
    if (sp.n)
      sa::bulk_copy(stages + st * (cap + kStagePad), seq - m + sp.a, sp.n,
                    &full[st]);
  };

  if (threadIdx.x == 0) {
    sa::mbar_init(&full[0], 1);
    sa::mbar_init(&full[1], 1);
    sa::mbar_init_fence();
  }
  int t = blockIdx.x;   // the grid has no more blocks than tiles
  plan(t, 0, fetch(t));
  int32_t raw = fetch(t + gridDim.x);
  __syncthreads();
  if (threadIdx.x == 0) stage(0);
  for (int j = 0; t < ntiles; t += gridDim.x, ++j) {
    const int st = j & 1, next = t + gridDim.x;
    // stage st ^ 1 and its starts were last read before the barrier that
    // ended the step before
    if (next < ntiles) plan(next, st ^ 1, raw);
    raw = fetch(next + gridDim.x);
    __syncthreads();
    if (next < ntiles && threadIdx.x == 0) stage(st ^ 1);

    const Span sp = tile_span(wlo[st], whi[st], W, m, L, cap);
    const uint8_t* tile = stages + st * (cap + kStagePad);
    const int row0 = t * kTileRows;
    const int nrows = B - row0 < kTileRows ? B - row0 : kTileRows;
    sa::mbar_wait(&full[st], (j >> 1) & 1);
    for (int r = warp; r < nrows; r += nwarps) {
      const int64_t s = s_row[st][r];
      const int64_t off = s + m - sp.a;
      const bool fits = off >= 0 && off + W <= sp.n;
      uint8_t* orow = out + static_cast<size_t>(row0 + r) * W;
      if (wide) {
        uint4* o = reinterpret_cast<uint4*>(orow);
        if (fits) {
          const uint4* src =
              reinterpret_cast<const uint4*>(tile) + (off >> 4);
          const int by = static_cast<int>(off & 15);
#pragma unroll 2
          for (int u = lane; u < W / 16; u += 32)
            sa::store16(o + u, sa::cut16(src[u], src[u + 1], by));
        } else {
#pragma unroll 2
          for (int u = lane; u < W / 16; u += 32)
            sa::store16(o + u, direct16(seq, L, s + 16 * u, m));
        }
      } else {
        uint32_t* o = reinterpret_cast<uint32_t*>(orow);
        if (fits) {
          const uint32_t* src =
              reinterpret_cast<const uint32_t*>(tile) + (off >> 2);
          const int sh = 8 * static_cast<int>(off & 3);
          for (int w = lane; w < W / 4; w += 32)
            o[w] = __funnelshift_r(src[w], src[w + 1], sh);
        } else {
          for (int w = lane; w < W / 4; w += 32)
            o[w] = load4(seq + s + 4 * w);
        }
      }
    }
    __syncthreads();   // every read of stage st is done: it may be refilled
  }
}

// Shared memory and threads a block for a stage of `cap` bytes: the more
// a block stages, the fewer blocks an SM holds, so each gets more threads.
struct TileLaunch {
  int smem, threads;
};

TileLaunch tile_launch(int cap) {
  const int smem = 2 * (cap + kStagePad);
  return {smem, smem <= 24 * 1024 ? 256 : (smem <= 56 * 1024 ? 512 : 1024)};
}

}  // namespace

extern "C" cudaError_t sa_gather_rows(const void* seq, int64_t L,
                                      const void* starts, int B, int W,
                                      void* out, void* stream) {
  if (B == 0) return cudaSuccess;
  gather_rows_kernel<<<(B + kRowsPerBlock - 1) / kRowsPerBlock, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), L,
      static_cast<const int32_t*>(starts), B, W, static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

extern "C" cudaError_t sa_gather_rows_tile(const void* seq, int64_t L,
                                           const void* starts, int B, int W,
                                           int T, void* out, void* stream) {
  if (W <= 0 || W % 4 || W > L || T <= 0 || T > kMaxT)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  // blocks the card holds at once, by device and T: 0 until first asked
  static std::atomic<int> resident[kMaxDevices][kMaxT + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int cap = T * 128 < kMaxStage ? T * 128 : kMaxStage;
  const TileLaunch tl = tile_launch(cap);
  int room = resident[dev][T].load(std::memory_order_relaxed);
  if (room == 0) {
    // the first launch of this T on this device: room for two stages of
    // the largest T, far above the 48 KB a block gets without opting in
    if ((err = cudaFuncSetAttribute(
             gather_rows_tile_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             tile_launch(kMaxStage).smem)) != cudaSuccess)
      return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, gather_rows_tile_kernel, tl.threads, tl.smem)) !=
        cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    room = per_sm * sms;
    resident[dev][T].store(room, std::memory_order_relaxed);
  }
  // every block the same number of tiles, as nearly as they divide
  const int ntiles = (B + kTileRows - 1) / kTileRows;
  const int rounds = (ntiles + room - 1) / room;
  const int grid = (ntiles + rounds - 1) / rounds;
  gather_rows_tile_kernel<<<grid, tl.threads, tl.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), L,
      static_cast<const int32_t*>(starts), B, W, cap,
      static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

extern "C" const char* sa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
