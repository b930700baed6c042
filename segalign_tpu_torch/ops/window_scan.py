"""K4: one continuation window from the carried extension state.

Counterpart of segalign_tpu/ops/extend_tiled.py window_scan_tall. r/q are
the raw (B, W) windows in ascending storage order: [loc + tile, loc + tile
+ W) for the right extension, [loc - tile - W, loc - tile) for the left
one, which is scanned from its last byte down (extension offset p = tile +
W - f at storage lane f). Rows done on entry pass through unchanged.

window_scan_seq (K4s) is the whole continuation of both directions of a
program in one launch: every row not done walks these windows, read
straight from the padded sequences, tile after tile until it is done. It
computes what the host-stepped survivor loop (extend_fused.run_survivors:
a gather of each sequence and a window_scan a step) computes, with no
gathered rows and no host step (csrc/window_scan.cu's second entry point).
"""

from __future__ import annotations

import torch

from .. import _build
from .extend3 import STATE_KEYS, check_tensors
from .extend3 import scan_raw_window as window_scan_plain
from .first_scan import check_seq
from .launches import count_launch

# rows a window_scan_seq launch takes at most: its list holds 2 row + left
# in an int32
MAX_SEQ_ROWS = 1 << 29


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


def _check_seq(ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub, W):
    B = loc_r.shape[0]
    states = []
    for side, st in (("st_r", st_r), ("st_l", st_l)):
        for k in STATE_KEYS:
            states.append((f"{side}[{k!r}]", st[k],
                           torch.bool if k == "done" else torch.int32,
                           (B, 4) if k in ("counts", "cdel") else (B,)))
    check_seq(ref_pad, query_pad, loc_r, loc_q, sub, states, W, W)
    if B >= MAX_SEQ_ROWS:
        raise ValueError(f"{B} rows, at most {MAX_SEQ_ROWS - 1} a launch")


def window_scan_seq_plain(ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub,
                          xdrop: int, ref_len: int, query_len: int, *,
                          pad: int, tile: int, W: int, with_counts: bool):
    """The survivor loop of each direction with the plain gather and scan
    (run_survivors(..., plain=True) in steps of at most SURVIVOR_ROWS
    rows). Updates st_r and st_l in place and returns them."""
    # imported here: extend_fused imports this module
    from . import extend_fused
    kw = dict(pad=pad, tile=tile, W=W, with_counts=with_counts,
              rows=extend_fused.SURVIVOR_ROWS, plain=True)
    for st, left in ((st_r, False), (st_l, True)):
        extend_fused.run_survivors(ref_pad, query_pad, loc_r, loc_q, st, sub,
                                   xdrop, ref_len, query_len, left=left, **kw)
    return st_r, st_l


def window_scan_seq(ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub,
                    xdrop: int, ref_len: int, query_len: int, *, pad: int,
                    tile: int, W: int, with_counts: bool):
    """K4s: run every row of both directions that is not done to its end,
    W-wide windows from offset `tile` on, each window's start clamped as
    gather_rows clamps it; ref_pad/query_pad are the 1-D uint8 padded
    sequences (16-byte aligned). Updates the states st_r and st_l in place
    and returns them. CPU tensors take window_scan_seq_plain; CUDA tensors
    launch csrc/window_scan.cu's sa_window_scan_seq."""
    _check_seq(ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub, W)
    if ref_pad.device.type == "cpu":
        return window_scan_seq_plain(
            ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub, xdrop,
            ref_len, query_len, pad=pad, tile=tile, W=W,
            with_counts=with_counts)
    B = loc_r.shape[0]
    # the launch's four counters (the launcher zeroes them on the stream)
    # and its list of rows
    scratch = torch.empty(4 + 2 * B, dtype=torch.int32, device=loc_r.device)
    _build.launch(
        "sa_window_scan_seq", ref_pad.data_ptr(), ref_pad.numel(),
        query_pad.data_ptr(), query_pad.numel(), loc_r.data_ptr(),
        loc_q.data_ptr(), sub.data_ptr(), B, int(tile), W, int(pad),
        int(xdrop), int(ref_len), int(query_len), int(with_counts),
        *[st[k].data_ptr() for st in (st_r, st_l) for k in STATE_KEYS],
        scratch.data_ptr(), _build.stream_of(ref_pad.device))
    count_launch(window_scan_seq)
    return st_r, st_l


window_scan_seq.launches = 0
