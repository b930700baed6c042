// K5: one W-wide x-drop window from the carried state, in extension order.
//
// Replaces segalign_tpu/ops/extend_pallas.py window_scan_pallas
// (_window_scan_kernel), the window step of the host-stepped engine on the
// device-seeding route. Input is (B, W) byte windows in extension order:
// lane k is extension offset tile + k to the right and tile + 1 + k to the
// left (the caller flips the left windows). The in-bounds mask and the
// edge test come from the anchors; rows already done pass through
// unchanged.
//
// Bound on the H100: bytes. At the device route's first window (B = 2^17
// rows, all alive, W = 2048) the function reads 2 x 2^17 x 2048 bytes of
// windows, 536.9 MB, and reads and writes 12.8 MB of state and anchors:
// 0.164 ms at 3.35 TB/s, against 1.6e9 integer operations (about six a
// lane), 0.024 ms at 67e12 a second. Later windows hold fewer rows, half
// of them done: 16384 rows with 8192 alive are 0.0105 ms, as for K4.
// Design (scan.cuh, carried_scan_kernel without the raw layout): a warp
// walks a row in four steps of 512 lanes, each thread loading 16
// contiguous bytes of r and of q, ascending in both directions since the
// caller has flipped the left windows; shuffle scans join the threads; a
// done row's warp copies its state and exits, and a row stops reading
// past its last in-bounds lane. Sums are exact int32, as the TPU kernel's
// are.
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

extern "C" cudaError_t sa_window_scan_wide(
    const void* r, const void* q, const void* loc_r, const void* loc_q,
    const void* cum, const void* maxv, const void* maxp, const void* done,
    const void* counts, const void* cdel, const void* sub, int B, int W,
    int xdrop, int tile, int ref_len, int query_len, int left,
    int with_counts, void* o_done, void* o_cum, void* o_maxv, void* o_maxp,
    void* o_counts, void* o_cdel, void* stream) {
  return sa::launch_carried_scan<false>(
      r, q, loc_r, loc_q, cum, maxv, maxp, done, counts, cdel, sub, B, W,
      xdrop, tile, ref_len, query_len, left, with_counts, o_done, o_cum,
      o_maxv, o_maxp, o_counts, o_cdel, stream);
}
