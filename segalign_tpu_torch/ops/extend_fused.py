"""Extend a hit batch to completion in both directions.

Counterpart of segalign_tpu/ops/extend_fused.py extend_fields_program and
_extend_core: the same fields dict (candidate, rs, qs, length, total,
counts) for the same rows.

  1. One 2W-wide gather per sequence (gather_rows, or gather_rows_tile for
     blocks whose windows cluster) and the first window of both directions
     (first_scan).
  2. The survivors of each direction continue at W_CONT, compacted to the
     rows still alive before every step: a gather (gather_rows) and a scan
     (window_scan) per step, until no row is alive.
  3. finalize, with the right counts plus the left counts: both directions
     start from zero counts, and the count fold is additive in its start.

The TPU scheduling of the JAX program (cohort rounds, cascade ladders,
joint while_loops, blocked prefix sums, unrolled overshoot) changes no
output and has no counterpart: each row's extension is independent of
every other row's, so any order of steps gives the same state.

The work follows the tensors' device: CUDA tensors launch the kernels, CPU
tensors run their plain versions.
"""

from __future__ import annotations

import torch

from .extend3 import STATE_KEYS, finalize
from .first_scan import first_scan
from .gather import gather_rows, gather_rows_tile
from .window_scan import window_scan
from .window_scan_wide import window_scan_wide

Q_TILE = 64    # staged rows of 128 bytes for query-side first windows
R_TILE = 512   # and for clustered reference-side ones


def run_survivors(seq_r, seq_q, loc_r, loc_q, st, sub, xdrop, ref_len,
                  query_len, *, pad, tile, W, left, with_counts,
                  wide: bool = False):
    """Run the alive rows of one direction to completion, W-wide windows
    from offset `tile` on, compacted to the rows still alive before every
    step. Each step is a gather (gather_rows) and a scan: window_scan on
    the raw windows, or with `wide` window_scan_wide on windows in
    extension order (the left ones flipped). Updates and returns `st` in
    place (its tensors belong to this batch)."""
    scan = window_scan_wide if wide else window_scan
    idx = torch.nonzero(~st["done"]).squeeze(1)
    while idx.numel():
        lr, lq = loc_r[idx], loc_q[idx]
        off = -tile - W if left else tile
        r = gather_rows(seq_r, pad + lr + off, W)
        q = gather_rows(seq_q, pad + lq + off, W)
        if wide and left:
            r, q = r.flip(1), q.flip(1)
        cst = scan(r, q, lr, lq, {k: st[k][idx] for k in STATE_KEYS}, sub,
                   xdrop, tile, ref_len, query_len, W=W, left=left,
                   with_counts=with_counts)
        for k in STATE_KEYS:
            st[k][idx] = cst[k]
        idx = idx[~cst["done"]]
        tile += W
    return st


def extend_fields_program(ref_pad, query_pad, ref_loc, query_loc, m: int,
                          sub, xdrop: int, hspthresh: int, ref_len: int,
                          query_len: int, *, pad: int, W: int = 512,
                          W_CONT: int = 2048, with_counts: bool = False,
                          qtile: bool = False, rtile: bool = False):
    """Extend rows [0, m) of a hit batch; rows past m are padding.

    ref_pad/query_pad: 1-D uint8 padded sequences with `pad` bytes before
    position 0 and at least `pad` after the end; ref_loc/query_loc: (B,)
    int32 anchors; sub: (64,) int32 table. qtile/rtile select the tile
    gather for the query/reference side of the first window (the caller
    checks the spans with gather.tile_spans_ok)."""
    if pad < max(W, W_CONT):
        raise ValueError(f"pad={pad} must cover W={W} and W_CONT={W_CONT}")
    B = ref_loc.shape[0]
    dev = ref_loc.device
    valid = torch.arange(B, device=dev) < m
    loc_r, loc_q = ref_loc, query_loc
    r_start = pad + loc_r - W
    q_start = pad + loc_q - W
    r2 = (gather_rows_tile(ref_pad, r_start, 2 * W, R_TILE) if rtile
          else gather_rows(ref_pad, r_start, 2 * W))
    q2 = (gather_rows_tile(query_pad, q_start, 2 * W, Q_TILE) if qtile
          else gather_rows(query_pad, q_start, 2 * W))
    st_r, st_l = first_scan(r2, q2, loc_r, loc_q, valid, sub, xdrop, ref_len,
                            query_len, W=W, with_counts=with_counts)
    del r2, q2
    kw = dict(pad=pad, tile=W, W=W_CONT, with_counts=with_counts)
    st_r = run_survivors(ref_pad, query_pad, loc_r, loc_q, st_r, sub, xdrop,
                         ref_len, query_len, left=False, **kw)
    st_l = run_survivors(ref_pad, query_pad, loc_r, loc_q, st_l, sub, xdrop,
                         ref_len, query_len, left=True, **kw)
    return finalize(valid, loc_r, loc_q, st_r["maxv"], st_r["maxp"],
                    st_l["maxv"], st_l["maxp"],
                    st_r["counts"] + st_l["counts"], hspthresh)
