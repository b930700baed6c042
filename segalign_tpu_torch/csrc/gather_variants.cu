// S1 and S2: the gather experiment's kernels, (B,) starts -> (B, W) bytes.
//
// S1 replaces scripts/exp_gather_variants.py _mk (_v1_kernel, _v2_kernel,
// _v3_kernel), S2 replaces _mk4 (_v4_kernel). The experiment splits the
// TPU's per-row gather (K2) into its pieces: copy each row's bytes into
// fast memory, then cut the window out of them at the row's byte offset.
// The three S1 modes are one kernel template, and every mode goes through
// shared memory (the experiment holds staging against K2's and S2's direct
// loads):
//
//   load only        out[i, k] = seq[(starts[i] / 1024) * 1024 + k]: the W
//                    bytes at the row's 1024-aligned address are staged and
//                    written as they lie;
//   extract only     no sequence byte is read: the block zero-fills its
//                    bank once and cuts every row from it at the row's
//                    offset, so the output is zeros (the Pallas
//                    interpreter's value of the TPU kernel's never-written
//                    scratch);
//   double-buffered  out[i, k] = seq[starts[i] + k], K2's function: a block
//                    walks its share of the row blocks with two banks and
//                    issues block t+1's copies before it cuts block t.
//
// Starts are not clamped: the caller keeps them in [0, L - AW] with AW =
// max(2048, W + 1024), the TPU kernels' aligned superset, as the JAX
// variants require. Nothing here stages that superset: a row's staged bytes
// are the 16-byte aligned cover of its window, W + 16 bytes from
// starts[i] & ~15 (W bytes in load only), which the caller's range keeps
// inside the sequence.
//
// Bound on the H100: bytes. Each mode's function writes B x W bytes and reads
// 4 bytes a start and, but for extract only, the sequence once: at the
// experiment's shape (B = 2^17, W = 512, a 1 MB sequence) 68.6 MB, 0.020 ms
// at 3.35 TB/s, twice that for S2's two sides (137.3 MB, 0.041 ms). What S1
// moves beside that: W + 16 bytes a row from L2 (the experiment's sequences
// are about 1 MB and sit there) through shared memory. Staging is 16-byte
// cp.async copies, a warp a row, into banks of ROWS rows of W + 16 bytes:
// 8 KB a block at W = 512 in every mode (one bank of 16 rows, or two of 8
// when double-buffered). The cut reads two aligned 16-byte shared words a
// thread and funnel-shifts them to the row's offset (cut16), which a warp
// learns once a row, and stores one uint4 (a streaming store); the zero
// fill is uint4 stores. A block walks a few row blocks (kWalk: 4 when
// double-buffered, so that the double buffer has a next block to prefetch,
// else 2, which halves extract only's zero fill), and the grid is as many
// blocks as that takes. A grid of only the blocks the card holds at once,
// each walking its share of everything, was slower in every mode on an
// H100 (extract only by 13%): the writes are the bound, and many short
// blocks keep every SM writing to the end. So the launcher looks nothing
// up and keeps nothing.
//
// S2 gathers both sides of a row index in one block with direct loads
// (no staging): each thread reads the aligned 32-bit word of its four bytes
// and, off a word boundary, the next one, and funnel-shifts them, so
// neighbouring threads read neighbouring words of one row.
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTwoRows = 8;    // S2 rows per block, each side
constexpr int kAlign = 1024;   // the TPU's HBM slice alignment
constexpr int kMaxW = 2048;    // 32 KB of banks a block
constexpr int kRowPad = 16;    // a row's aligned cover is W + 16 bytes

enum Mode : int { kLoadOnly = 0, kExtractOnly = 1, kDoubleBuffered = 2 };

// S1 rows per shared bank: the same shared memory a block in every mode
// (8 KB at W = 512), so that the modes run at the same occupancy
template <int MODE>
constexpr int kRows = MODE == kDoubleBuffered ? 8 : 16;

// Row blocks a block walks: the double buffer needs a next block to
// prefetch, extract only spreads its zero fill over them. More blocks than
// the card holds at once, each with little to walk, keep the SMs evenly
// busy to the end; a grid of resident blocks that walk everything does not.
template <int MODE>
constexpr int kWalk = MODE == kDoubleBuffered ? 4 : 2;

// A warp takes rows warp, warp + kWarps, ... of a row block. Its rows'
// starts (0 past the last row); every lane reads the same words.
template <int ROWS>
struct WarpStarts {
  int32_t s[ROWS / kWarps];
};

template <int ROWS>
__device__ __forceinline__ WarpStarts<ROWS> warp_starts(
    const int32_t* __restrict__ starts, int B, int row0) {
  WarpStarts<ROWS> w;
#pragma unroll
  for (int k = 0; k < ROWS / kWarps; ++k) {
    const int row = row0 + (threadIdx.x >> 5) + kWarps * k;
    w.s[k] = row < B ? __ldg(starts + row) : 0;
  }
  return w;
}

// Start the copies of rows [row0, row0 + ROWS) into bank and commit them as
// one group: W bytes from the row's 1024-aligned address, or with COVER the
// W + 16 bytes of the aligned cover of its window.
template <int ROWS, bool COVER>
__device__ __forceinline__ void issue_block(const uint8_t* __restrict__ seq,
                                            const WarpStarts<ROWS>& mine,
                                            int B, int W, int row0,
                                            uint8_t* bank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = W / 16 + (COVER ? 1 : 0);
#pragma unroll
  for (int k = 0; k < ROWS / kWarps; ++k) {
    const int r = warp + kWarps * k;
    if (row0 + r >= B) break;
    const int32_t s = mine.s[k];
    const uint8_t* src =
        seq + (COVER ? static_cast<int64_t>(s & ~15)
                     : static_cast<int64_t>(s / kAlign) * kAlign);
    uint8_t* dst = bank + r * (W + kRowPad);
    for (int c = lane; c < chunks; c += 32)
      sa::cp_async16(dst + 16 * c, src + 16 * c);
  }
  sa::cp_async_commit();
}

// Write rows [row0, row0 + ROWS) from bank: each row's first W bytes, or
// with ROTATE its W bytes from offset starts[i] % 16.
template <int ROWS, bool ROTATE>
__device__ __forceinline__ void extract_block(const uint8_t* bank,
                                              const WarpStarts<ROWS>& mine,
                                              int B, int W, int row0,
                                              uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < ROWS / kWarps; ++k) {
    const int r = warp + kWarps * k;
    if (row0 + r >= B) break;
    const int off = mine.s[k] & 15;
    const uint4* src =
        reinterpret_cast<const uint4*>(bank + r * (W + kRowPad));
    uint4* o = reinterpret_cast<uint4*>(
        out + static_cast<size_t>(row0 + r) * W);
    for (int u = lane; u < W / 16; u += 32)
      sa::store16(o + u,
                  ROTATE ? sa::cut16(src[u], src[u + 1], off) : src[u]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    gather_variant_kernel(const uint8_t* __restrict__ seq,
                          const int32_t* __restrict__ starts, int B, int W,
                          uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int ROWS = kRows<MODE>;
  const int bank_bytes = ROWS * (W + kRowPad);
  const int nblk = (B + ROWS - 1) / ROWS;
  int t = blockIdx.x;   // the grid has no more blocks than row blocks
  // a row block's starts are read one step before they are used
  WarpStarts<ROWS> mine = warp_starts<ROWS>(starts, B, t * ROWS);
  if (MODE == kExtractOnly) {
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < bank_bytes / 16; i += blockDim.x)
      p[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (; t < nblk; t += gridDim.x) {
      const WarpStarts<ROWS> ahead =
          warp_starts<ROWS>(starts, B, (t + gridDim.x) * ROWS);
      extract_block<ROWS, true>(smem, mine, B, W, t * ROWS, out);
      mine = ahead;
    }
  } else if (MODE == kLoadOnly) {
    for (; t < nblk; t += gridDim.x) {
      issue_block<ROWS, false>(seq, mine, B, W, t * ROWS, smem);
      mine = warp_starts<ROWS>(starts, B, (t + gridDim.x) * ROWS);
      sa::cp_async_wait<0>();
      __syncthreads();
      extract_block<ROWS, false>(smem, mine, B, W, t * ROWS, out);
      __syncthreads();  // the bank is refilled next
    }
  } else {
    issue_block<ROWS, true>(seq, mine, B, W, t * ROWS, smem);
    for (int j = 0; t < nblk; t += gridDim.x, ++j) {
      const int next = t + gridDim.x;
      const WarpStarts<ROWS> ahead =
          warp_starts<ROWS>(starts, B, next * ROWS);
      // the other bank was last read before the previous __syncthreads;
      // past the last row block the group is empty
      issue_block<ROWS, true>(seq, ahead, B, W, next * ROWS,
                              smem + ((j + 1) & 1) * bank_bytes);
      sa::cp_async_wait<1>();  // block t's group; block t+1's may be in flight
      __syncthreads();
      extract_block<ROWS, true>(smem + (j & 1) * bank_bytes, mine, B, W,
                                t * ROWS, out);
      __syncthreads();
      mine = ahead;
    }
  }
}

template <int MODE>
cudaError_t launch_variant(const void* seq, const void* starts, int B, int W,
                           void* out, void* stream) {
  if (W <= 0 || W % 16 || W > kMaxW) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  // at most 33 KB at the widest W: under the 48 KB a block gets unasked,
  // so no attribute is set and nothing of the device is looked up
  const int smem =
      (MODE == kDoubleBuffered ? 2 : 1) * kRows<MODE> * (W + kRowPad);
  const int nblk = (B + kRows<MODE> - 1) / kRows<MODE>;
  gather_variant_kernel<MODE>
      <<<(nblk + kWalk<MODE> - 1) / kWalk<MODE>, kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(seq),
          static_cast<const int32_t*>(starts), B, W,
          static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
    gather_two_sided_kernel(const uint8_t* __restrict__ seq_r,
                            const uint8_t* __restrict__ seq_q,
                            const int32_t* __restrict__ starts2, int B, int W,
                            uint32_t* __restrict__ out_r,
                            uint32_t* __restrict__ out_q) {
  const int words = W / 4;
  const int row0 = blockIdx.x * kTwoRows;
  const int nrows = B - row0 < kTwoRows ? B - row0 : kTwoRows;
  const int per_side = nrows * words;
  for (int i = threadIdx.x; i < 2 * per_side; i += blockDim.x) {
    const int side = i >= per_side;
    const int k = i - side * per_side;
    const int row = row0 + k / words, w = k % words;
    const int64_t s =
        static_cast<int64_t>(__ldg(starts2 + side * static_cast<int64_t>(B) +
                                   row)) +
        4 * w;
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(side ? seq_q : seq_r) + (s >> 2);
    const int sh = 8 * static_cast<int>(s & 3);
    const uint32_t lo = __ldg(p);
    // a window on a word boundary reads no word past its last byte
    const uint32_t v = sh ? __funnelshift_r(lo, __ldg(p + 1), sh) : lo;
    (side ? out_q : out_r)[static_cast<size_t>(row) * words + w] = v;
  }
}

}  // namespace

extern "C" cudaError_t sa_gather_dma_only(const void* seq, const void* starts,
                                          int B, int W, void* out,
                                          void* stream) {
  return launch_variant<kLoadOnly>(seq, starts, B, W, out, stream);
}

extern "C" cudaError_t sa_gather_extract_only(const void* seq,
                                              const void* starts, int B,
                                              int W, void* out,
                                              void* stream) {
  return launch_variant<kExtractOnly>(seq, starts, B, W, out, stream);
}

extern "C" cudaError_t sa_gather_dbuf(const void* seq, const void* starts,
                                      int B, int W, void* out, void* stream) {
  return launch_variant<kDoubleBuffered>(seq, starts, B, W, out, stream);
}

extern "C" cudaError_t sa_gather_two_sided(const void* seq_r,
                                           const void* seq_q,
                                           const void* starts2, int B, int W,
                                           void* out_r, void* out_q,
                                           void* stream) {
  if (W <= 0 || W % 16) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  gather_two_sided_kernel<<<(B + kTwoRows - 1) / kTwoRows, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq_r), static_cast<const uint8_t*>(seq_q),
      static_cast<const int32_t*>(starts2), B, W,
      static_cast<uint32_t*>(out_r), static_cast<uint32_t*>(out_q));
  return cudaGetLastError();
}
