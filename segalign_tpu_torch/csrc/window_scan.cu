// K4: a continuation x-drop window from the carried extension state.
//
// Replaces segalign_tpu/ops/extend_tiled.py window_scan_tall
// (_window_scan_tall_kernel). Input is the raw (B, W) byte windows in
// ascending storage order: the right extension at [loc + tile, loc + tile
// + W), the left one at [loc - tile - W, loc - tile), scanned in descending
// order with extension offset p = tile + W - f for storage lane f. Rows
// already done pass through unchanged.
//
// Bound on the H100: bytes. An alive row's 2 x W window bytes are read
// once (fewer at a sequence end), and every row's 45 bytes of state and 8
// of anchors are read and 45 written. At the main path's shape (16384
// rows, 8192 alive on entry, W = 2048) that is 33.6 MB of windows and
// 1.6 MB of state, 0.0105 ms at 3.35 TB/s; the arithmetic (about six
// integer operations a lane, 0.1e9) is 0.0015 ms at 67e12 a second. So
// small a launch is near its floor of a few microseconds, and what counts
// is to spread the alive rows over the whole card: a warp walks a row
// (scan.cuh, carried_scan_kernel), so 8192 alive rows are 262144 threads
// on all 132 SMs, each step of a warp reads 512 contiguous bytes an array,
// four steps a window, a done row's warp copies its state and exits, and a
// row stops reading past its last in-bounds lane. The TPU kernel's
// shortcuts (a bf16 matmul prefix sum, 16-bit packed count sums) are not
// carried over: sums here are exact int32.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

extern "C" cudaError_t sa_window_scan(
    const void* r, const void* q, const void* loc_r, const void* loc_q,
    const void* cum, const void* maxv, const void* maxp, const void* done,
    const void* counts, const void* cdel, const void* sub, int B, int W,
    int xdrop, int tile, int ref_len, int query_len, int left,
    int with_counts, void* o_done, void* o_cum, void* o_maxv, void* o_maxp,
    void* o_counts, void* o_cdel, void* stream) {
  return sa::launch_carried_scan<true>(
      r, q, loc_r, loc_q, cum, maxv, maxp, done, counts, cdel, sub, B, W,
      xdrop, tile, ref_len, query_len, left, with_counts, o_done, o_cum,
      o_maxv, o_maxp, o_counts, o_cdel, stream);
}
