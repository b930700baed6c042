// S1 and S2: the gather experiment's kernels, (B,) starts -> (B, W) bytes.
//
// S1 replaces scripts/exp_gather_variants.py _mk (_v1_kernel, _v2_kernel,
// _v3_kernel), S2 replaces _mk4 (_v4_kernel). The experiment splits the
// TPU's per-row gather (K2) into its pieces: copy each row's 1024-aligned
// AW = max(2048, W + 1024) byte superset into fast memory, then rotate the
// window out of it at the row's offset starts[i] % 1024. The three S1 modes
// are one kernel template:
//
//   load only        out[i, k] = seq[(starts[i] / 1024) * 1024 + k]: the
//                    supersets are staged and the first W bytes written
//                    unrotated;
//   extract only     no sequence byte is read: the block zero-fills its
//                    bank once and rotate-extracts every row from it, so
//                    the output is zeros (the Pallas interpreter's value
//                    of the TPU kernel's never-written scratch);
//   double-buffered  out[i, k] = seq[starts[i] + k], K2's function: a block
//                    walks its share of the row blocks with two banks and
//                    issues block t+1's copies before it extracts block t.
//
// Starts are not clamped: the caller keeps them in [0, L - AW], as the JAX
// variants require, so every superset lies inside the sequence.
//
// Bound on the H100: bytes. Each mode's function writes B x W bytes and reads
// 4 bytes a start and, but for extract only, the sequence once: at the
// experiment's shape (B = 2^17, W = 512, a 1 MB sequence) 68.6 MB, 0.020 ms
// at 3.35 TB/s, twice that for S2's two sides (137.3 MB, 0.041 ms). What the
// kernels move is more: the supersets read AW bytes a row (4x W at W = 512)
// where K2 reads W; the experiment's sequences are about 1 MB and sit in L2,
// so the loads are L2 traffic. Staging uses 16-byte cp.async copies into
// banks of ROWS x AW bytes of dynamic shared memory: 64 KB a block at W = 512
// in every mode (one bank of 32 rows, or two of 16 when double-buffered),
// where the TPU's 256 rows a block would need 512 KB. The extraction reads
// two aligned 32-bit words of the bank and funnel-shifts them to the row's
// byte offset, so a warp reads and writes 128 bytes a row in aligned words.
// The grid is the blocks the card holds at once; each block loops over row
// blocks, which amortises the extract-only zero fill and gives the double
// buffer a next block to prefetch.
//
// S2 gathers both sides of a row index in one block with direct loads
// (no staging): each thread reads the aligned 32-bit word of its four bytes
// and, off a word boundary, the next one, and funnel-shifts them, so
// neighbouring threads read neighbouring words of one row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTwoRows = 8;    // S2 rows per block, each side
constexpr int kAlign = 1024;   // the TPU's HBM slice alignment
constexpr int kMaxW = 2048;    // 96 KB a block at AW = 3072

enum Mode : int { kLoadOnly = 0, kExtractOnly = 1, kDoubleBuffered = 2 };

// S1 rows per shared bank: 64 KB a block in every mode at W = 512, so that
// the modes run at the same occupancy (three blocks an SM)
template <int MODE>
constexpr int kRows = MODE == kDoubleBuffered ? 16 : 32;

__host__ __device__ constexpr int awin_for(int W) {
  return W + kAlign > 2048 ? W + kAlign : 2048;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of the supersets of rows [row0, row0 + ROWS) into bank
// and commit them as one group.
template <int ROWS>
__device__ __forceinline__ void issue_block(const uint8_t* __restrict__ seq,
                                            const int32_t* __restrict__ starts,
                                            int B, int AW, int row0,
                                            uint8_t* bank) {
  const int chunks = AW / 16;
  const int nrows = B - row0 < ROWS ? B - row0 : ROWS;
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const int64_t aligned =
        static_cast<int64_t>(__ldg(starts + row0 + r) / kAlign) * kAlign;
    cp_async16(bank + r * AW + 16 * c, seq + aligned + 16 * c);
  }
  cp_async_commit();
}

// Write rows [row0, row0 + ROWS) from bank: each row's first W bytes, or
// with ROTATE its W bytes from offset starts[i] % 1024.
template <int ROWS, bool ROTATE>
__device__ __forceinline__ void extract_block(
    const uint8_t* bank, const int32_t* __restrict__ starts, int B, int W,
    int AW, int row0, uint32_t* __restrict__ out) {
  const int words = W / 4;
  const int nrows = B - row0 < ROWS ? B - row0 : ROWS;
  for (int i = threadIdx.x; i < nrows * words; i += blockDim.x) {
    const int r = i / words, w = i - r * words;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(bank + r * AW);
    uint32_t v;
    if (ROTATE) {
      // off + W + 3 < 1024 + W <= AW: both words lie in the row's superset
      const int off = __ldg(starts + row0 + r) % kAlign + 4 * w;
      v = __funnelshift_r(row[off >> 2], row[(off >> 2) + 1], 8 * (off & 3));
    } else {
      v = row[w];
    }
    out[static_cast<size_t>(row0 + r) * words + w] = v;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    gather_variant_kernel(const uint8_t* __restrict__ seq,
                          const int32_t* __restrict__ starts, int B, int W,
                          uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int ROWS = kRows<MODE>;
  const int AW = awin_for(W);
  const int bank_bytes = ROWS * AW;
  const int nblk = (B + ROWS - 1) / ROWS;
  if (MODE == kExtractOnly) {
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < bank_bytes / 16; i += blockDim.x)
      p[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (int t = blockIdx.x; t < nblk; t += gridDim.x)
      extract_block<ROWS, true>(smem, starts, B, W, AW, t * ROWS, out);
  } else if (MODE == kLoadOnly) {
    for (int t = blockIdx.x; t < nblk; t += gridDim.x) {
      issue_block<ROWS>(seq, starts, B, AW, t * ROWS, smem);
      cp_async_wait<0>();
      __syncthreads();
      extract_block<ROWS, false>(smem, starts, B, W, AW, t * ROWS, out);
      __syncthreads();  // the bank is refilled next
    }
  } else {
    int t = blockIdx.x;
    if (t < nblk) issue_block<ROWS>(seq, starts, B, AW, t * ROWS, smem);
    for (int j = 0; t < nblk; t += gridDim.x, ++j) {
      const int next = t + gridDim.x;
      // the other bank was last read before the previous __syncthreads
      if (next < nblk)
        issue_block<ROWS>(seq, starts, B, AW, next * ROWS,
                          smem + ((j + 1) & 1) * bank_bytes);
      else
        cp_async_commit();
      cp_async_wait<1>();  // block t's group; block t+1's may be in flight
      __syncthreads();
      extract_block<ROWS, true>(smem + (j & 1) * bank_bytes, starts, B, W,
                                AW, t * ROWS, out);
      __syncthreads();
    }
  }
}

template <int MODE>
cudaError_t launch_variant(const void* seq, const void* starts, int B, int W,
                           void* out, void* stream) {
  if (W <= 0 || W % 16 || W > kMaxW) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int smem =
      (MODE == kDoubleBuffered ? 2 : 1) * kRows<MODE> * awin_for(W);
  cudaError_t err = cudaFuncSetAttribute(
      gather_variant_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gather_variant_kernel<MODE>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const int nblk = (B + kRows<MODE> - 1) / kRows<MODE>;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  gather_variant_kernel<MODE>
      <<<nblk < resident ? nblk : resident, kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(seq),
          static_cast<const int32_t*>(starts), B, W,
          static_cast<uint32_t*>(out));
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
