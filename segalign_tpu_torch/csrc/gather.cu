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
// row is a contiguous read that a warp covers in 128-byte pieces, 4 bytes a
// thread, and the output is written in aligned 32-bit words.
//
// K3 serves blocks of 128 rows whose windows cluster (query-sorted hits,
// tandem-dense reference blocks): the block stages the span its windows
// cover once in shared memory, with cooperative loads, and cuts the rows
// out of it. A row whose window does not fit the staged span (the span is
// capped at T x 128 bytes) reads global memory instead, so the output never
// depends on how the rows cluster.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;   // K2 rows per block
constexpr int kTileRows = 128;     // K3 rows per block

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

__global__ void gather_rows_tile_kernel(const uint8_t* __restrict__ seq,
                                        int64_t L,
                                        const int32_t* __restrict__ starts,
                                        int B, int W, int tile_bytes,
                                        uint32_t* __restrict__ out) {
  extern __shared__ uint8_t tile[];
  __shared__ int64_t s_row[kTileRows];
  __shared__ unsigned long long lo, hi;
  const int row0 = blockIdx.x * kTileRows;
  const int nrows = B - row0 < kTileRows ? B - row0 : kTileRows;
  if (threadIdx.x == 0) {
    lo = ~0ull;
    hi = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const int64_t s = clamp_start(starts[row0 + i], L - W);
    s_row[i] = s;
    atomicMin(&lo, static_cast<unsigned long long>(s));
    atomicMax(&hi, static_cast<unsigned long long>(s));
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(lo);
  const int64_t span = static_cast<int64_t>(hi) + W - base;
  const int64_t staged = span < tile_bytes ? span : tile_bytes;
  for (int64_t i = threadIdx.x; i < staged; i += blockDim.x)
    tile[i] = seq[base + i];
  __syncthreads();
  const int words = W / 4;
  for (int i = threadIdx.x; i < nrows * words; i += blockDim.x) {
    const int r = i / words, w = i % words;
    const int64_t off = s_row[r] - base;
    const uint32_t v = off + W <= staged ? load4(tile + off + 4 * w)
                                         : load4(seq + s_row[r] + 4 * w);
    out[static_cast<size_t>(row0 + r) * words + w] = v;
  }
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
  if (B == 0) return cudaSuccess;
  const int tile_bytes = T * 128;
  // T = 512 stages 64 KB, above the 48 KB a block gets without opting in
  cudaError_t err = cudaFuncSetAttribute(
      gather_rows_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_bytes);
  if (err != cudaSuccess) return err;
  gather_rows_tile_kernel<<<(B + kTileRows - 1) / kTileRows, 256, tile_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), L,
      static_cast<const int32_t*>(starts), B, W, tile_bytes,
      static_cast<uint32_t*>(out));
  return cudaGetLastError();
}

extern "C" const char* sa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
