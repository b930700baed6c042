"""Experiment: decompose the per-row window gather (K2) and time variants.

Counterpart of scripts/exp_gather_variants.py. Cases (each a standalone
kernel, not the main path's):

  v0_prod   K2, ops/gather.py gather_rows (the baseline)
  v1_dma    S1 load only: the W bytes at each row's 1024-aligned address
            staged in shared memory, written as they lie
  v2_rot    S1 extract only: every row cut at its byte offset from a zeroed
            bank, no sequence bytes read
  v3_dbuf   S1 double-buffered: the aligned cover of each window staged,
            block t+1's copies issued before t is cut
  v4_fused  S2: the r and q windows of a row in one launch (2B rows)

B = 131072 windows of W = 512 from sequences of 1e6 + AW + 8192 codes
(rng 7), starts uniform in [0, 1e6). For each case: the host time of its
first launch after the kernel library is built, then the median device
time of `inner` launches (CUDA events, after a warmup) and ns per row.

    python -m segalign_tpu_torch.scripts.exp_gather_variants [inner]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import event_ms, first_call_ms, print_card, require_cuda
from .. import _build
from ..ops.gather import gather_rows
from ..ops.gather_variants import (awin_for, gather_dbuf, gather_dma_only,
                                   gather_extract_only, gather_two_sided)

B = 131072
W = 512
AW = awin_for(W)
N = 1_000_000


def make_inputs(dev):
    """(seq, seq2, starts, starts2) of the experiment, on `dev`."""
    rng = np.random.default_rng(7)
    seq = rng.integers(0, 4, N + AW + 8192).astype(np.uint8)
    seq2 = rng.integers(0, 4, N + AW + 8192).astype(np.uint8)
    starts = rng.integers(0, N, B).astype(np.int32)
    starts_q = rng.integers(0, N, B).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (
        seq, seq2, starts, np.concatenate([starts, starts_q])))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    inner = int(argv[0]) if argv else 16
    if inner < 1:
        raise SystemExit("exp_gather_variants: inner must be at least 1")
    dev = require_cuda("exp_gather_variants")
    print_card("exp_gather_variants")
    seq, seq2, starts, starts2 = make_inputs(dev)
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cases = [("v0_prod", lambda: gather_rows(seq, starts, W), B),
             ("v1_dma", lambda: gather_dma_only(seq, starts, W), B),
             ("v2_rot", lambda: gather_extract_only(seq, starts, W), B),
             ("v3_dbuf", lambda: gather_dbuf(seq, starts, W), B),
             ("v4_fused", lambda: gather_two_sided(seq, seq2, starts2, W),
              2 * B)]
    for name, fn, rows in cases:
        first = first_call_ms(fn)
        ms = event_ms(fn, warm=2, iters=inner)
        print(f"{name:9s} first={first:8.3f}ms per_call={ms:8.4f}ms "
              f"ns_per_row={ms * 1e6 / rows:7.3f}", flush=True)


if __name__ == "__main__":
    main()
