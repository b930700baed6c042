// K1: the first x-drop window of both extension directions.
//
// Replaces segalign_tpu/ops/extend_pallas.py first_scan_pallas
// (_first_scan_kernel). Input is one (B, 2W) pair of byte rows per hit,
// gathered at loc - W: lanes [0, W) are the left extension, scanned right
// to left; lanes [W, 2W) are the right extension. The initial state is
// implicit (cum = maxv = 0, maxp = -1 right and 0 left, zero counts).
//
// Bound on the H100: bytes. The function reads the 2 x 2W bytes of a
// row's r2 and q2 once and writes 2 x 45 bytes of state; at the main path's
// shape (B = 2^17, W = 512) that is 268.4 MB of windows, 1.2 MB of anchors
// and 11.8 MB of state, 0.084 ms at 3.35 TB/s. Its arithmetic is about six
// integer operations a lane (a table lookup, an add, a max, a subtract and
// two compares), 0.8e9 in all, 0.012 ms at the 67e12 a second of the
// card's non-tensor units. A row whose window ends at a sequence end needs
// fewer bytes (only in-bounds lanes are read). Design (scan.cuh): one warp
// walks one (row, direction); its 32 threads load 16 contiguous bytes each,
// 512 contiguous bytes an array, which at W = 512 is the whole window in
// one step, and shuffle scans join the threads' partial sums and maxima.
// Blocks are one direction each, so a warp never diverges on the
// direction; eight warps a block.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

// One direction of one row, by one warp. The window's bytes, the anchors
// and the valid flag are loaded together, before the branch on the flag
// (a row that is not valid reads a window it does not use; such rows are
// few).
template <bool LEFT>
__device__ __forceinline__ void first_half(
    const uint8_t* __restrict__ r, const uint8_t* __restrict__ q,
    const int32_t* __restrict__ loc_r, const int32_t* __restrict__ loc_q,
    const bool* __restrict__ valid, const sa::Tables& tab,
    const int32_t* zero4, int row, int W, int32_t xdrop, int32_t ref_len,
    int32_t query_len, bool with_counts, const sa::State& out) {
  const int lane = threadIdx.x & 31;
  const sa::Offsets o0 = sa::first_chunk<LEFT>(r, q, W);
  const int64_t lr = loc_r[row], lq = loc_q[row];
  const int32_t init_maxp = LEFT ? 0 : -1;
  if (!valid[row]) {
    if (lane == 0) {
      out.done[row] = true;
      out.cum[row] = 0;
      out.maxv[row] = 0;
      out.maxp[row] = init_maxp;
    }
    if (lane < 4) {
      out.counts[row * 4 + lane] = 0;
      out.cdel[row * 4 + lane] = 0;
    }
    return;
  }
  // left: lane W - p holds the byte at extension offset p = 1 .. W
  const int64_t a = ref_len - lr, b = query_len - lq;
  const int64_t lim = LEFT ? (lr < lq ? lr : lq) + 1 : (a < b ? a : b);
  sa::scan_window<LEFT>(r, q, W, tab, xdrop, LEFT ? 1 : 0, lim, o0, 0, 0,
                        init_maxp, zero4, zero4, with_counts, out, row);
}

__global__ void __launch_bounds__(sa::WARPS_PER_BLOCK * 32)
    first_scan_kernel(const uint8_t* __restrict__ r2,
                      const uint8_t* __restrict__ q2,
                      const int32_t* __restrict__ loc_r,
                      const int32_t* __restrict__ loc_q,
                      const bool* __restrict__ valid,
                      const int32_t* __restrict__ sub_g, int B, int W,
                      int32_t xdrop, int32_t ref_len, int32_t query_len,
                      bool with_counts, sa::State right, sa::State left) {
  __shared__ sa::Tables tab;
  __shared__ int32_t zero4[4];
  if (threadIdx.x < 4) zero4[threadIdx.x] = 0;
  sa::load_tables(tab, sub_g);
  const int row = blockIdx.x * sa::WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= B) return;
  const size_t base = static_cast<size_t>(row) * 2 * W;
  if (blockIdx.y == 1) {
    first_half<true>(r2 + base, q2 + base, loc_r, loc_q, valid, tab, zero4,
                     row, W, xdrop, ref_len, query_len, with_counts, left);
  } else {
    first_half<false>(r2 + base + W, q2 + base + W, loc_r, loc_q, valid, tab,
                      zero4, row, W, xdrop, ref_len, query_len, with_counts,
                      right);
  }
}

}  // namespace

extern "C" cudaError_t sa_first_scan(
    const void* r2, const void* q2, const void* loc_r, const void* loc_q,
    const void* valid, const void* sub, int B, int W, int xdrop, int ref_len,
    int query_len, int with_counts, void* r_done, void* r_cum, void* r_maxv,
    void* r_maxp, void* r_counts, void* r_cdel, void* l_done, void* l_cum,
    void* l_maxv, void* l_maxp, void* l_counts, void* l_cdel,
    void* stream) {
  const sa::State right{static_cast<bool*>(r_done),
                        static_cast<int32_t*>(r_cum),
                        static_cast<int32_t*>(r_maxv),
                        static_cast<int32_t*>(r_maxp),
                        static_cast<int32_t*>(r_counts),
                        static_cast<int32_t*>(r_cdel)};
  const sa::State left{static_cast<bool*>(l_done),
                       static_cast<int32_t*>(l_cum),
                       static_cast<int32_t*>(l_maxv),
                       static_cast<int32_t*>(l_maxp),
                       static_cast<int32_t*>(l_counts),
                       static_cast<int32_t*>(l_cdel)};
  if (B == 0) return cudaSuccess;
  const dim3 grid((B + sa::WARPS_PER_BLOCK - 1) / sa::WARPS_PER_BLOCK, 2);
  first_scan_kernel<<<grid, sa::WARPS_PER_BLOCK * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r2), static_cast<const uint8_t*>(q2),
      static_cast<const int32_t*>(loc_r), static_cast<const int32_t*>(loc_q),
      static_cast<const bool*>(valid), static_cast<const int32_t*>(sub), B, W,
      xdrop, ref_len, query_len, with_counts != 0, right, left);
  return cudaGetLastError();
}
