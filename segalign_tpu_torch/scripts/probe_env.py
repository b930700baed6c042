"""Probe what a launch, a host sync and a copy to the host cost on the card.

Counterpart of scripts/probe_env.py, with torch ops in place of XLA's. The
port compiles no programs, so where the JAX probes timed a compile this one
times the first run, and the while_loop probe times the port's own
host-stepped loop. Every time is the host clock around calls that end in a
synchronize (median, min, max of `iters` runs after a warmup).

Probes:
  dispatch  a tiny op and a sync; 20 chained tiny ops and one sync; a tiny
            reduce and a sync
  d2h       .cpu() of 4, 2^14 and 2^20 int32
  while_    100 host-stepped steps of x * 1.000001 + 0.5 on (256, 512) f32:
            one sync at the end, then a torch.nonzero sync every step (the
            shape of ops/extend_fused.py run_survivors)
  scan      8 window-like steps at B = 8192, W = 512: table lookup, cumsum,
            cummax
  fused     expand (searchsorted and two takes, HBUF = 2^15), then extend
            (W = 512 windows, cumsum, cummax, max): split with a sync
            between, and back to back with one sync
  pallas    S3, the hand kernel sa_scale2 (ops/probe.py) on (256, 512) f32:
            its first launch, then the steady state beside torch's x * 2,
            one call a sync and 100 chained calls a sync

    python -m segalign_tpu_torch.scripts.probe_env [probe ...]
"""

from __future__ import annotations

import sys
import time

import torch

from . import first_call_ms, host_bench, print_card, require_cuda
from .. import _build
from ..ops.probe import scale2


def probe_dispatch(dev, iters):
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    host_bench("tiny-op sync dispatch", lambda: x + 1, 1, iters)

    def chain20():
        y = x
        for _ in range(20):
            y = y + 1
        return y
    host_bench("20 chained tiny ops + 1 sync", chain20, 1, iters)
    host_bench("tiny-reduce sync dispatch", lambda: (x * 2 + 1).sum(), 1,
               iters)


def probe_d2h(dev, iters):
    for n in (4, 1 << 14, 1 << 20):
        x = torch.ones((n,), dtype=torch.int32, device=dev)
        host_bench(f".cpu() {n} int32", lambda x=x: x.cpu(), 1, iters)


def probe_while(dev, iters):
    x = torch.ones((256, 512), dtype=torch.float32, device=dev)

    def loop():
        y = x
        for _ in range(100):
            y = y * 1.000001 + 0.5
        return y

    def loop_synced():
        y = x
        for _ in range(100):
            y = y * 1.000001 + 0.5
            torch.nonzero(y[:, 0] > 0)
        return y
    print(f"host loop(100) first run: {first_call_ms(loop):.3f} ms",
          flush=True)
    host_bench("host loop(100), one sync", loop, 1, iters)
    host_bench("host loop(100), a torch.nonzero sync per step", loop_synced,
               1, iters)


def probe_scan(dev, iters):
    W, B = 512, 8192
    r = torch.zeros((B, W), dtype=torch.int64, device=dev)
    q = torch.zeros((B, W), dtype=torch.int64, device=dev)
    sub = torch.zeros(64, dtype=torch.int32, device=dev)

    def f():
        cum = torch.zeros(B, dtype=torch.int32, device=dev)
        mx = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(8):
            sc = sub[r * 8 + q]
            ct = torch.cumsum(sc, dim=1, dtype=torch.int32) + cum[:, None]
            rm = torch.cummax(ct, dim=1).values
            cum, mx = ct[:, -1], torch.maximum(mx, rm[:, -1])
        return cum, mx
    print(f"8 window-ish steps first run: {first_call_ms(f):.3f} ms",
          flush=True)
    host_bench("8 window-ish steps steady", f, 1, iters)


def probe_fused(dev, iters):
    HBUF, W = 1 << 15, 512
    N = 1 << 22
    seq = torch.zeros((N,), dtype=torch.uint8, device=dev)
    cum = torch.arange(1, (1 << 18) + 1, dtype=torch.int32, device=dev)
    pos_table = torch.zeros((1 << 20,), dtype=torch.int32, device=dev)
    sub = torch.zeros(64, dtype=torch.int32, device=dev)

    def expand(g0=0):
        g = g0 + torch.arange(HBUF, dtype=torch.int32, device=dev)
        sidx = torch.searchsorted(cum, g, right=True).clamp_(
            max=cum.numel() - 1)
        bp = cum[sidx].clamp(0, pos_table.numel() - 1)
        return pos_table[bp.long()], sidx

    def extend1(loc):
        r = seq.unfold(0, W, 1)[loc.long()].long()
        ct = torch.cumsum(sub[r * 9], dim=1, dtype=torch.int32)
        return torch.cummax(ct, dim=1).values.amax(dim=1)

    print(f"expand first run: {first_call_ms(expand):.3f} ms", flush=True)
    loc, _ = expand()
    print(f"extend first run: {first_call_ms(lambda: extend1(loc)):.3f} ms",
          flush=True)
    host_bench("fused steady (expand, extend, one sync)",
               lambda: extend1(expand()[0]), 1, iters)
    a = host_bench("split steady (expand)", expand, 1, iters)
    b = host_bench("split steady (extend)", lambda: extend1(loc), 1, iters)
    print(f"split sum: {(a + b) * 1e3:.4f} ms", flush=True)


def probe_pallas(dev, iters):
    x = torch.ones((256, 512), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"sa_scale2 (256, 512) f32 first launch: "
          f"{first_call_ms(lambda: scale2(x)):.3f} ms", flush=True)
    host_bench("sa_scale2 (256, 512) f32 steady", lambda: scale2(x), 1,
               iters)
    host_bench("torch x * 2 (256, 512) f32 steady", lambda: x * 2, 1, iters)

    def chain(fn):
        def run():
            for _ in range(100):
                fn()
        return run
    a = host_bench("sa_scale2 100 chained launches + 1 sync",
                   chain(lambda: scale2(x)), 1, iters)
    b = host_bench("torch x * 2 100 chained + 1 sync", chain(lambda: x * 2),
                   1, iters)
    print(f"per chained call: sa_scale2 {a * 1e4:.4f} us, torch "
          f"{b * 1e4:.4f} us", flush=True)


PROBES = dict(dispatch=probe_dispatch, d2h=probe_d2h, while_=probe_while,
              scan=probe_scan, fused=probe_fused, pallas=probe_pallas)


def main(argv=None, iters: int = 5):
    names = (sys.argv[1:] if argv is None else argv) or list(PROBES)
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise SystemExit(f"probe_env: unknown probe(s) {unknown}; choose "
                         f"from {list(PROBES)}")
    dev = require_cuda("probe_env")
    print_card("probe_env")
    for n in names:
        print(f"--- {n} ---", flush=True)
        t0 = time.perf_counter()
        PROBES[n](dev, iters)
        print(f"({n}: {time.perf_counter() - t0:.1f} s total)", flush=True)


if __name__ == "__main__":
    main()
