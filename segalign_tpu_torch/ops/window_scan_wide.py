"""K5: one W-wide x-drop window from the carried state, in extension order.

Counterpart of segalign_tpu/ops/extend_pallas.py window_scan_pallas, the
window step of the host-stepped engine (ops/extend3.py
extend_hits_windowed) on the device-seeding route. r/q are (B, W) windows
in extension order: lane 0 is the first position the extension reaches,
so the caller flips the left windows. The in-bounds mask and the edge test
come from the anchors. Rows done on entry pass through unchanged. Exact
int32 sums, as the TPU kernel's roll scans are.
"""

from __future__ import annotations

from .extend3 import scan_ext_window as window_scan_wide_plain
from .launches import count_launch
from .window_scan import check_window, launch_window


def window_scan_wide(r, q, loc_r, loc_q, st, sub, xdrop: int, tile: int,
                     ref_len: int, query_len: int, *, W: int, left: bool,
                     with_counts: bool):
    """CPU tensors take window_scan_wide_plain; CUDA tensors launch
    csrc/window_scan_wide.cu. Returns the new state dict."""
    check_window(r, q, loc_r, loc_q, st, sub, W)
    args = (r, q, loc_r, loc_q, st, sub, xdrop, tile, ref_len, query_len)
    kw = dict(W=W, left=left, with_counts=with_counts)
    if r.device.type == "cpu":
        return window_scan_wide_plain(*args, **kw)
    out = launch_window("sa_window_scan_wide", *args, **kw)
    count_launch(window_scan_wide)
    return out


window_scan_wide.launches = 0
