"""K4: one continuation window from the carried extension state.

Counterpart of segalign_tpu/ops/extend_tiled.py window_scan_tall. r/q are
the raw (B, W) windows in ascending storage order: [loc + tile, loc + tile
+ W) for the right extension, [loc - tile - W, loc - tile) for the left
one, which is scanned from its last byte down (extension offset p = tile +
W - f at storage lane f). Rows done on entry pass through unchanged.
"""

from __future__ import annotations

import torch

from .. import _build
from .extend3 import STATE_KEYS, check_tensors
from .extend3 import scan_raw_window as window_scan_plain
from .launches import count_launch


def check_window(r, q, loc_r, loc_q, st, sub, W):
    """The argument checks of both carried-state window scans (K4, K5)."""
    B = r.shape[0]
    args = [("r", r, torch.uint8, (B, W)), ("q", q, torch.uint8, (B, W)),
            ("loc_r", loc_r, torch.int32, (B,)),
            ("loc_q", loc_q, torch.int32, (B,)),
            ("sub", sub, torch.int32, (64,))]
    for k in STATE_KEYS:
        args.append((k, st[k], torch.bool if k == "done" else torch.int32,
                     (B, 4) if k in ("counts", "cdel") else (B,)))
    check_tensors(args, r.device, W)


def launch_window(name, r, q, loc_r, loc_q, st, sub, xdrop, tile, ref_len,
                  query_len, *, W, left, with_counts):
    """Launch one carried-state window scan (`name` is its launcher) and
    return the new state dict."""
    out = {k: torch.empty_like(st[k]) for k in STATE_KEYS}
    _build.launch(
        name, r.data_ptr(), q.data_ptr(), loc_r.data_ptr(),
        loc_q.data_ptr(), st["cum"].data_ptr(), st["maxv"].data_ptr(),
        st["maxp"].data_ptr(), st["done"].data_ptr(),
        st["counts"].data_ptr(), st["cdel"].data_ptr(), sub.data_ptr(),
        r.shape[0], W, int(xdrop), int(tile), int(ref_len), int(query_len),
        int(left), int(with_counts),
        *[out[k].data_ptr() for k in STATE_KEYS],
        _build.stream_of(r.device))
    return out


def window_scan(r, q, loc_r, loc_q, st, sub, xdrop: int, tile: int,
                ref_len: int, query_len: int, *, W: int, left: bool,
                with_counts: bool):
    """CPU tensors take window_scan_plain; CUDA tensors launch
    csrc/window_scan.cu. Returns the new state dict."""
    check_window(r, q, loc_r, loc_q, st, sub, W)
    args = (r, q, loc_r, loc_q, st, sub, xdrop, tile, ref_len, query_len)
    kw = dict(W=W, left=left, with_counts=with_counts)
    if r.device.type == "cpu":
        return window_scan_plain(*args, **kw)
    out = launch_window("sa_window_scan", *args, **kw)
    count_launch(window_scan)
    return out


window_scan.launches = 0
