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
// Bound on the H100: the same dependent chain per lane as K4 (a running
// sum, a running max and the drop test), here over up to 2^17 rows of
// W = 2048 at the route's first window, so 512 MiB of windows per launch.
// One thread walks one row in 16-byte loads that ascend in both directions
// (scan.cuh, carried_scan_kernel without the raw layout): each load brings
// 16 lanes, the table lookups hit 256 bytes of shared memory, done rows
// exit at once and a row stops reading past its last in-bounds lane. The
// TPU kernel's log-step roll scans buy nothing on a thread that walks the
// lanes in order; its exact int32 sums are kept.
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
