"""Extend a hit batch to completion in both directions.

Counterpart of segalign_tpu/ops/extend_fused.py extend_fields_program and
_extend_core: the same fields dict (candidate, rs, qs, length, total,
counts) for the same rows. extend_fields is the engine of both routes: the
native route's programs (pipeline/program.py extend_program, counts off)
and the device-seeding route's hit ranges and the sharded table's
(extend3.extend_hits_windowed, counts on). extend_fields_program is the
JAX program's signature over it, which the tests hold to the JAX
package.

  1. The first window of both directions, read straight from the padded
     sequences (first_scan_seq: what first_scan computes on one 2W-wide
     gather per sequence, with no gathered rows).
  2. The survivors of both directions continue at W_CONT, each row to its
     end, in one launch (window_scan_seq, K4s: its windows read straight
     from the padded sequences, with no host step between them). Its plain
     version is the host-stepped survivor loop (run_survivors): the rows
     still alive before every step, a gather (gather_rows) and a scan
     (window_scan) a step of at most SURVIVOR_ROWS rows, until no row is
     alive. With `wide` the loop is the step of the check engine
     extend3.extend_hits_stepped (K2 gathers and K5 scans from tile 0), on
     no pipeline path.
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

from typing import Optional

import torch

from .extend3 import STATE_KEYS, finalize
from .first_scan import first_scan_seq
from .gather import gather_rows, gather_rows_plain
from .window_scan import window_scan, window_scan_plain, window_scan_seq
from .window_scan_wide import window_scan_wide, window_scan_wide_plain

# alive rows a survivor step of window_scan_seq's plain version gathers at
# most: the step's windows take 2 x W_CONT bytes a row (64 MiB at 2^14 rows
# and W_CONT 2048), and on a repeat-rich pair tens of thousands of a
# program's 2^17 hits can outlive their first windows; None runs each step
# whole
SURVIVOR_ROWS = 1 << 14


def run_survivors(seq_r, seq_q, loc_r, loc_q, st, sub, xdrop, ref_len,
                  query_len, *, pad, tile, W, left, with_counts,
                  wide: bool = False, rows: Optional[int] = None,
                  plain: bool = False):
    """Run the alive rows of one direction to completion, W-wide windows
    from offset `tile` on, compacted to the rows still alive before every
    step; with `rows`, a step of more alive rows runs as several of at
    most `rows` each (rows are independent: no field changes). Each step
    is a gather (gather_rows) and a scan: window_scan on the raw windows,
    or with `wide` window_scan_wide on windows in extension order (the
    left ones flipped); with `plain`, their plain versions whatever the
    device. Updates and returns `st` in place (its tensors belong to this
    batch)."""
    if plain:
        gather = gather_rows_plain
        scan = window_scan_wide_plain if wide else window_scan_plain
    else:
        gather = gather_rows
        scan = window_scan_wide if wide else window_scan
    idx = torch.nonzero(~st["done"]).squeeze(1)
    while idx.numel():
        off = -tile - W if left else tile
        alive = []
        for part in (idx.split(rows) if rows else (idx,)):
            lr, lq = loc_r[part], loc_q[part]
            r = gather(seq_r, pad + lr + off, W)
            q = gather(seq_q, pad + lq + off, W)
            if wide and left:
                r, q = r.flip(1), q.flip(1)
            cst = scan(r, q, lr, lq, {k: st[k][part] for k in STATE_KEYS},
                       sub, xdrop, tile, ref_len, query_len, W=W, left=left,
                       with_counts=with_counts)
            del r, q   # before the next part's windows
            for k in STATE_KEYS:
                st[k][part] = cst[k]
            alive.append(part[~cst["done"]])
        idx = torch.cat(alive) if len(alive) > 1 else alive[0]
        tile += W
    return st


def extend_fields(ref_pad, query_pad, loc_r, loc_q, valid, sub, xdrop: int,
                  hspthresh: int, ref_len: int, query_len: int, *, pad: int,
                  W: int, W_CONT: int, with_counts: bool):
    """The fields dict of finalize for the rows where `valid` (the other
    rows start done and finalize to zero): K1s, K4s, finalize. The engine
    of both routes (program.extend_program, extend3.extend_hits_windowed).

    ref_pad/query_pad: 1-D uint8 padded sequences with `pad` bytes before
    position 0 and at least `pad` after the end; loc_r/loc_q: (B,) int32
    anchors; valid: (B,) bool; sub: (64,) int32 table."""
    if pad < max(W, W_CONT):
        raise ValueError(f"pad={pad} must cover W={W} and W_CONT={W_CONT}")
    st_r, st_l = first_scan_seq(ref_pad, query_pad, loc_r, loc_q, valid, sub,
                                xdrop, ref_len, query_len, pad=pad, W=W,
                                with_counts=with_counts)
    window_scan_seq(ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub, xdrop,
                    ref_len, query_len, pad=pad, tile=W, W=W_CONT,
                    with_counts=with_counts)
    return finalize(valid, loc_r, loc_q, st_r["maxv"], st_r["maxp"],
                    st_l["maxv"], st_l["maxp"],
                    st_r["counts"] + st_l["counts"], hspthresh)


def extend_fields_program(ref_pad, query_pad, ref_loc, query_loc, m: int,
                          sub, xdrop: int, hspthresh: int, ref_len: int,
                          query_len: int, *, pad: int, W: int = 512,
                          W_CONT: int = 2048, with_counts: bool = False):
    """Extend rows [0, m) of a hit batch (extend_fields); rows past m are
    padding."""
    valid = torch.arange(ref_loc.shape[0], device=ref_loc.device) < m
    return extend_fields(ref_pad, query_pad, ref_loc, query_loc, valid, sub,
                         xdrop, hspthresh, ref_len, query_len, pad=pad, W=W,
                         W_CONT=W_CONT, with_counts=with_counts)
