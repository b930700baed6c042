"""Microbench of extension-path pieces on the card.

Counterpart of scripts/probe_extension.py, with torch ops in place of
XLA's and the port's kernels in place of the Pallas ones. Every time is the
host clock around calls that end in a synchronize (median, min, max of
`iters` runs after two warmups).

Probes:
  gather        index gathers at B = 2^15, W = 128 and 512 from a 64 MB
                sequence, random vs sorted starts; sort and argsort; the
                (B, 2, 128) row-take superset; K2 (ops/gather.py
                gather_rows), random vs sorted; K3 (gather_rows_tile,
                T = 64) on the same starts, and what choosing between
                the two costs the host: the span check of one program's
                2^17 starts (the clip and tile_spans_ok, as
                pipeline/device.py calls them), microseconds a call
  scan          K5 (ops/window_scan_wide.py) at B = 2^15, W = 512, tile 0,
                fresh state, beside a torch scan-only version
  searchsorted  searchsorted at S = 5 * 2^20, B = 2^15; take of 5M random
                and sorted indices from a 64 MB table
  d2h           .cpu() of (B, 8) and (2^20,) int32, and of 6 separate (B,)
                arrays
  overhead      a tiny torch op, a mid (8192, 512) mul+sum, S4 (the hand
                kernel sa_scale2, ops/probe.py) on (8, 128) f32, the tiny
                torch op again; then what one launch through the port's
                launcher costs the host, piece by piece, on (256, 512) f32
                (microseconds a call, `calls` back to back with one
                synchronize at the end, best of five): `x * 2` and
                `torch.mul(out=)`, the scale2 wrapper, `_build.launch`
                with the pointers ready, the bound ctypes function alone,
                the stream handle read the public way and through
                `_build.stream_of`, `torch.empty_like`, two `data_ptr()`
  scan2         the pieces of the window scan at (B, 128) and (B, 512):
                lookup, cumsum, cummax, the bf16 matmul cumsum, the full
                scan (torch has no associative scan: that line is left out)

    python -m segalign_tpu_torch.scripts.probe_extension [probe ...]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import host_bench, print_card, require_cuda
from .. import _build
from ..ops.extend3 import init_state
from ..ops.gather import gather_rows, gather_rows_tile, tile_spans_ok
from ..ops.probe import scale2
from ..ops.window_scan_wide import window_scan_wide

SEQ_N = 1 << 26  # 64 MB reference arena
B = 1 << 15
XDROP = 910


def _to(a, dev):
    return torch.from_numpy(a).to(dev)


def probe_gather(dev, iters):
    rng = np.random.default_rng(0)
    seq = _to(rng.integers(0, 4, SEQ_N).astype(np.uint8), dev)
    starts_np = rng.integers(0, SEQ_N - 4096, B).astype(np.int32)
    starts = _to(starts_np, dev)
    starts_sorted = _to(np.sort(starts_np), dev)
    for W in (128, 512):
        g = seq.unfold(0, W, 1)
        host_bench(f"torch index gather random B={B} W={W}",
                   lambda g=g: g[starts.long()], 2, iters)
        host_bench(f"torch index gather sorted B={B} W={W}",
                   lambda g=g: g[starts_sorted.long()], 2, iters)
    host_bench(f"sort+argsort B={B}",
               lambda: (torch.sort(starts).values, torch.argsort(starts)), 2,
               iters)
    seq2d = seq.view(-1, 128)
    two = torch.arange(2, device=dev)
    host_bench(f"2d row-take superset B={B} (2x128)",
               lambda: seq2d[(starts // 128).long()[:, None] + two], 2, iters)
    host_bench(f"K2 gather_rows B={B} W=512",
               lambda: gather_rows(seq, starts, 512), 2, iters)
    host_bench(f"K2 gather_rows sorted B={B} W=512",
               lambda: gather_rows(seq, starts_sorted, 512), 2, iters)
    host_bench(f"K3 gather_rows_tile T=64 B={B} W=512",
               lambda: gather_rows_tile(seq, starts, 512, 64), 2, iters)
    host_bench(f"K3 gather_rows_tile T=64 sorted B={B} W=512",
               lambda: gather_rows_tile(seq, starts_sorted, 512, 64), 2,
               iters)
    loc = np.sort(rng.integers(0, SEQ_N - 4096, 1 << 17)).astype(np.int32)
    us = _best_us(lambda: tile_spans_ok(
        np.clip(4096 + loc.astype(np.int64) - 512, 0, SEQ_N - 1024), 1024,
        64), iters)
    print(f"tile_spans_ok, the host's span check of 2^17 starts: "
          f"{us:.1f} us a call", flush=True)


def _scan_only(r, q, sub):
    sc = sub[r.long() * 8 + q.long()]
    ct = torch.cumsum(sc, dim=1, dtype=torch.int32)
    rm = torch.cummax(ct, dim=1).values
    drop = (rm - ct) > XDROP
    return ct[:, -1], rm.amax(dim=1), drop.any(dim=1)


def probe_scan_kernel(dev, iters):
    rng = np.random.default_rng(0)
    W, n = 512, 1 << 20
    r = _to(rng.integers(0, 4, (B, W)).astype(np.uint8), dev)
    q = _to(rng.integers(0, 4, (B, W)).astype(np.uint8), dev)
    loc_r = _to(rng.integers(0, n - W, B).astype(np.int32), dev)
    loc_q = _to(rng.integers(0, n - W, B).astype(np.int32), dev)
    sub = _to(rng.integers(-114, 91, 64).astype(np.int32), dev)
    st = init_state(B, -1, torch.ones(B, dtype=torch.bool, device=dev), dev)
    host_bench(f"K5 window_scan_wide B={B} W={W}",
               lambda: window_scan_wide(r, q, loc_r, loc_q, st, sub, XDROP,
                                        0, n, n, W=W, left=False,
                                        with_counts=False), 2, iters)
    host_bench(f"torch scan-only B={B} W={W}",
               lambda: _scan_only(r, q, sub), 2, iters)


def probe_searchsorted(dev, iters):
    rng = np.random.default_rng(0)
    S = 5 << 20
    cum_np = np.cumsum(rng.integers(0, 2, S).astype(np.int32))
    cum = _to(cum_np, dev)
    g = _to(np.sort(rng.integers(0, int(cum_np[-1]), B)).astype(np.int32),
            dev)
    host_bench(f"searchsorted S={S} B={B}",
               lambda: torch.searchsorted(cum, g, right=True), 2, iters)
    tbl = _to(rng.integers(0, 1 << 20, 1 << 24).astype(np.int32), dev)
    idx_np = rng.integers(0, 1 << 24, 5 << 20)
    idx = _to(idx_np, dev)
    host_bench("take 5M random from 64MB table", lambda: tbl[idx], 2, iters)
    idx_s = _to(np.sort(idx_np), dev)
    host_bench("take 5M sorted from 64MB table", lambda: tbl[idx_s], 2,
               iters)


def probe_d2h(dev, iters):
    for shape in ((B, 8), (1 << 20,)):
        x = torch.ones(shape, dtype=torch.int32, device=dev)
        host_bench(f".cpu() {shape}", lambda x=x: x.cpu(), 2, iters)
    xs = [torch.ones((B,), dtype=torch.int32, device=dev) for _ in range(6)]
    host_bench(".cpu() of 6 separate (B,) arrays",
               lambda: [x.cpu() for x in xs], 2, iters)


def probe_overhead(dev, iters):
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    host_bench("tiny torch", lambda: x + 1, 2, iters)
    big = torch.ones((1 << 13, 512), dtype=torch.int32, device=dev)
    host_bench("mid torch (8192,512) mul+sum",
               lambda: (big * 2 + 1).sum(dim=1), 2, iters)
    host_bench("tiny hand kernel sa_scale2 (8, 128) f32", lambda: scale2(x),
               2, iters)
    host_bench("tiny torch again", lambda: x + 1, 2, iters)
    _launch_cost(dev, 200 * iters)


def _best_us(fn, calls: int, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / calls)
    return best * 1e6


def _launch_cost(dev, calls):
    x = torch.ones((256, 512), device=dev)
    out = torch.empty_like(x)
    fn = _build.kernels()["sa_scale2"]
    stream = _build.stream_of(dev)
    xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()
    pieces = [
        ("torch x * 2", lambda: x * 2),
        ("torch.mul(x, 2, out=out)", lambda: torch.mul(x, 2, out=out)),
        ("scale2(x), the wrapper", lambda: scale2(x)),
        ("_build.launch, pointers ready",
         lambda: _build.launch("sa_scale2", xp, n, op, stream)),
        ("the bound ctypes function alone", lambda: fn(xp, n, op, stream)),
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("_build.stream_of(dev)", lambda: _build.stream_of(dev)),
        ("torch.empty_like(x)", lambda: torch.empty_like(x)),
        ("x.data_ptr(), out.data_ptr()",
         lambda: (x.data_ptr(), out.data_ptr())),
    ]
    print(f"us per call, {calls} back to back, best of 5", flush=True)
    for label, piece in pieces:
        print(f"{label}: {_best_us(piece, calls):.3f}", flush=True)


def probe_scan2(dev, iters):
    """The pieces of the window scan at (B, W) pipeline shapes."""
    rng = np.random.default_rng(0)
    sub = _to(rng.integers(-114, 91, 64).astype(np.int32), dev)
    for W in (128, 512):
        r = _to(rng.integers(0, 4, (B, W)), dev)
        q = _to(rng.integers(0, 4, (B, W)), dev)
        host_bench(f"take64 lookup (B,{W})", lambda r=r, q=q: sub[r * 8 + q],
                   2, iters)
        sc = _to(rng.integers(-114, 91, (B, W)).astype(np.int32), dev)
        host_bench(f"cumsum axis1 (B,{W}) i32",
                   lambda sc=sc: torch.cumsum(sc, dim=1, dtype=torch.int32),
                   2, iters)
        host_bench(f"cummax axis1 (B,{W}) i32",
                   lambda sc=sc: torch.cummax(sc, dim=1).values, 2, iters)
        scf = sc.float()
        host_bench(f"cumsum axis1 (B,{W}) f32",
                   lambda scf=scf: torch.cumsum(scf, dim=1), 2, iters)
        print(f"assoc_scan add (B,{W}) i32: left out (torch has no "
              f"associative scan)", flush=True)
        tri = torch.ones((W, W), dtype=torch.bfloat16, device=dev).tril()
        host_bench(f"matmul-cumsum (B,{W}) bf16",
                   lambda sc=sc, tri=tri: torch.matmul(
                       sc.to(torch.bfloat16), tri), 2, iters)
        host_bench(f"full scan (B,{W})",
                   lambda r=r, q=q: _scan_only(r, q, sub), 2, iters)


PROBES = dict(gather=probe_gather, scan=probe_scan_kernel,
              searchsorted=probe_searchsorted, d2h=probe_d2h,
              scan2=probe_scan2, overhead=probe_overhead)


def main(argv=None, iters: int = 10):
    names = (sys.argv[1:] if argv is None else argv) or list(PROBES)
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise SystemExit(f"probe_extension: unknown probe(s) {unknown}; "
                         f"choose from {list(PROBES)}")
    dev = require_cuda("probe_extension")
    print_card("probe_extension")
    for n in names:
        print(f"--- {n} ---", flush=True)
        PROBES[n](dev, iters)


if __name__ == "__main__":
    main()
