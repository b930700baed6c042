"""K1: the first x-drop window of both directions from one 2W-wide gather.

Counterpart of segalign_tpu/ops/extend_pallas.py first_scan_pallas. Row i
of r2/q2 holds positions [loc - W, loc + W) of the padded sequences: lanes
[0, W) are the left extension (scanned right to left), lanes [W, 2W) the
right one. Returns (st_right, st_left), the two directions' states after
their first window, as two window steps at tile 0 on fresh state give.
"""

from __future__ import annotations

import torch

from .. import _build
from .extend3 import check_tensors, init_state, scan_raw_window
from .launches import count_launch


def _check(r2, q2, loc_r, loc_q, valid, sub, W):
    B = r2.shape[0]
    check_tensors((("r2", r2, torch.uint8, (B, 2 * W)),
                   ("q2", q2, torch.uint8, (B, 2 * W)),
                   ("loc_r", loc_r, torch.int32, (B,)),
                   ("loc_q", loc_q, torch.int32, (B,)),
                   ("valid", valid, torch.bool, (B,)),
                   ("sub", sub, torch.int32, (64,))), r2.device, W)


def first_scan_plain(r2, q2, loc_r, loc_q, valid, sub, xdrop: int,
                     ref_len: int, query_len: int, *, W: int,
                     with_counts: bool):
    """Lanes [W, 2W) are the right window and lanes [0, W) the left one at
    tile 0, each scanned from a fresh state."""
    B, dev = r2.shape[0], r2.device
    kw = dict(W=W, with_counts=with_counts)
    st_r = scan_raw_window(r2[:, W:], q2[:, W:], loc_r, loc_q,
                           init_state(B, -1, valid, dev), sub, xdrop, 0,
                           ref_len, query_len, left=False, **kw)
    st_l = scan_raw_window(r2[:, :W], q2[:, :W], loc_r, loc_q,
                           init_state(B, 0, valid, dev), sub, xdrop, 0,
                           ref_len, query_len, left=True, **kw)
    return st_r, st_l


def first_scan(r2, q2, loc_r, loc_q, valid, sub, xdrop: int, ref_len: int,
               query_len: int, *, W: int, with_counts: bool):
    """CPU tensors take first_scan_plain; CUDA tensors launch
    csrc/first_scan.cu."""
    _check(r2, q2, loc_r, loc_q, valid, sub, W)
    if r2.device.type == "cpu":
        return first_scan_plain(r2, q2, loc_r, loc_q, valid, sub, xdrop,
                                ref_len, query_len, W=W,
                                with_counts=with_counts)
    B = r2.shape[0]
    outs = []
    for _ in range(2):
        outs.append(dict(
            done=torch.empty(B, dtype=torch.bool, device=r2.device),
            cum=torch.empty(B, dtype=torch.int32, device=r2.device),
            maxv=torch.empty(B, dtype=torch.int32, device=r2.device),
            maxp=torch.empty(B, dtype=torch.int32, device=r2.device),
            counts=torch.empty((B, 4), dtype=torch.int32, device=r2.device),
            cdel=torch.empty((B, 4), dtype=torch.int32, device=r2.device)))
    ptrs = [o[k].data_ptr() for o in outs
            for k in ("done", "cum", "maxv", "maxp", "counts", "cdel")]
    _build.launch(
        "sa_first_scan", r2.data_ptr(), q2.data_ptr(), loc_r.data_ptr(),
        loc_q.data_ptr(), valid.data_ptr(), sub.data_ptr(), B, W, int(xdrop),
        int(ref_len), int(query_len), int(with_counts), *ptrs,
        _build.stream_of(r2.device))
    count_launch(first_scan)
    return outs[0], outs[1]


first_scan.launches = 0
