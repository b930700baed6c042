"""K1: the first x-drop window of both directions from one 2W-wide gather.

Counterpart of segalign_tpu/ops/extend_pallas.py first_scan_pallas. Row i
of r2/q2 holds positions [loc - W, loc + W) of the padded sequences: lanes
[0, W) are the left extension (scanned right to left), lanes [W, 2W) the
right one. Returns (st_right, st_left), the two directions' states after
their first window, as two window steps at tile 0 on fresh state give.

first_scan_seq is the same function read straight from the padded
sequences, as the pipeline calls it: first_scan on the two gathers
gather_rows(ref_pad, pad + loc_r - W, 2W) and gather_rows(query_pad,
pad + loc_q - W, 2W), with no gathered rows between (the kernel's second
entry point in csrc/first_scan.cu). first_scan, on gathered rows, is the
counterpart the tests hold to first_scan_pallas.
"""

from __future__ import annotations

import torch

from .. import _build
from .extend3 import STATE_KEYS, check_tensors, init_state, scan_raw_window
from .gather import gather_rows_plain
from .launches import count_launch


def _empty_states(B: int, device):
    """The kernels' outputs: two states of B rows, and their pointers in
    the launchers' order."""
    outs = []
    for _ in range(2):
        outs.append(dict(
            done=torch.empty(B, dtype=torch.bool, device=device),
            cum=torch.empty(B, dtype=torch.int32, device=device),
            maxv=torch.empty(B, dtype=torch.int32, device=device),
            maxp=torch.empty(B, dtype=torch.int32, device=device),
            counts=torch.empty((B, 4), dtype=torch.int32, device=device),
            cdel=torch.empty((B, 4), dtype=torch.int32, device=device)))
    return outs, [o[k].data_ptr() for o in outs for k in STATE_KEYS]


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
    outs, ptrs = _empty_states(B, r2.device)
    _build.launch(
        "sa_first_scan", r2.data_ptr(), q2.data_ptr(), loc_r.data_ptr(),
        loc_q.data_ptr(), valid.data_ptr(), sub.data_ptr(), B, W, int(xdrop),
        int(ref_len), int(query_len), int(with_counts), *ptrs,
        _build.stream_of(r2.device))
    count_launch(first_scan)
    return outs[0], outs[1]


first_scan.launches = 0


def check_seq(ref_pad, query_pad, loc_r, loc_q, sub, extra, W: int,
              window: int):
    """The argument checks of the scans that read the padded sequences
    (K1s, K4s): 1-D uint8 sequences of at least `window` bytes, (B,) int32
    anchors, the (64,) table and the (name, tensor, dtype, shape) tuples
    of `extra`."""
    B = loc_r.shape[0]
    check_tensors((("ref_pad", ref_pad, torch.uint8, (ref_pad.numel(),)),
                   ("query_pad", query_pad, torch.uint8,
                    (query_pad.numel(),)),
                   ("loc_r", loc_r, torch.int32, (B,)),
                   ("loc_q", loc_q, torch.int32, (B,)),
                   ("sub", sub, torch.int32, (64,)), *extra),
                  ref_pad.device, W)
    for name, seq in (("ref_pad", ref_pad), ("query_pad", query_pad)):
        if seq.numel() < window:
            raise ValueError(f"{name} holds {seq.numel()} bytes, fewer than "
                             f"a window's {window}")


def first_scan_seq_plain(ref_pad, query_pad, loc_r, loc_q, valid, sub,
                         xdrop: int, ref_len: int, query_len: int, *,
                         pad: int, W: int, with_counts: bool):
    """The two gathers (gather_rows_plain), then first_scan_plain."""
    r2 = gather_rows_plain(ref_pad, pad + loc_r - W, 2 * W)
    q2 = gather_rows_plain(query_pad, pad + loc_q - W, 2 * W)
    return first_scan_plain(r2, q2, loc_r, loc_q, valid, sub, xdrop,
                            ref_len, query_len, W=W, with_counts=with_counts)


def first_scan_seq(ref_pad, query_pad, loc_r, loc_q, valid, sub, xdrop: int,
                   ref_len: int, query_len: int, *, pad: int, W: int,
                   with_counts: bool):
    """K1 on the padded sequences (1-D uint8, 16-byte aligned): the first
    window of both directions of every anchor, each window's start clamped
    as gather_rows clamps it. CPU tensors take first_scan_seq_plain; CUDA
    tensors launch csrc/first_scan.cu's sa_first_scan_seq."""
    check_seq(ref_pad, query_pad, loc_r, loc_q, sub,
              [("valid", valid, torch.bool, (loc_r.shape[0],))], W, 2 * W)
    if ref_pad.device.type == "cpu":
        return first_scan_seq_plain(
            ref_pad, query_pad, loc_r, loc_q, valid, sub, xdrop, ref_len,
            query_len, pad=pad, W=W, with_counts=with_counts)
    B = loc_r.shape[0]
    outs, ptrs = _empty_states(B, ref_pad.device)
    _build.launch(
        "sa_first_scan_seq", ref_pad.data_ptr(), ref_pad.numel(),
        query_pad.data_ptr(), query_pad.numel(), loc_r.data_ptr(),
        loc_q.data_ptr(), valid.data_ptr(), sub.data_ptr(), B, W, int(pad),
        int(xdrop), int(ref_len), int(query_len), int(with_counts), *ptrs,
        _build.stream_of(ref_pad.device))
    count_launch(first_scan_seq)
    return outs[0], outs[1]


first_scan_seq.launches = 0
