"""What the farm's queue and the two-host split cost: the counterpart of
scripts/measure_scaling.py (with _scaling_worker.py).

    python -m segalign_tpu_torch.scripts.measure_scaling [--device cuda:0]
        [--n 400000] [--chunk 32768] [--counts 1,2,4]

(a) farm: MultiDeviceAligner with 1, 2 and 4 aligners over both strands of
    every 32 kb chunk of make_pair(n, seed 5): the wall of map_chunks after
    a warm run, speedup and efficiency against one aligner, and every
    count's output equal to one aligner's, chunk-strand by chunk-strand.
    `--device cuda:0` holds every aligner on that card (the queue and its
    host threads, not what cards add); `--device cuda` gives each aligner a
    card of its own (cuda:0..N-1).
(b) two hosts: two processes (_scaling_worker, split mode) each align
    their round-robin half of the chunks with a DeviceAligner (a card each
    for `--device cuda`): each half's start-up, set-up and alignment walls,
    the wall from spawn to join, and the merge, whose output must equal one
    aligner's.

Prints the card first and `parity: identical` after each part; a
difference raises. The device is CUDA unless `--device cpu` is asked for
(the tests' small runs; their times are the CPU's), and without CUDA the
script exits at once.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from . import print_card, require_cuda
from .. import bench_inputs
from ..io.encode import revcomp_codes
from ..parallel.multi import MultiDeviceAligner
from ._scaling_worker import as_tuples, merge, run_workers, same, sync

PROG = "measure_scaling"


def make_pair(n=400_000, seed=5):
    """A random pair with diverged copies of reference pieces (2-20 kb at
    85% identity) planted in the query until they cover a tenth of it."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    total = 0
    while total < n // 10:
        ln = int(rng.integers(2000, 20000))
        src = int(rng.integers(0, n - ln))
        dst = int(rng.integers(0, n - ln))
        core = ref[src:src + ln]
        mut = rng.random(ln) >= 0.85
        query[dst:dst + ln] = np.where(
            mut, (core + rng.integers(1, 4, ln)) % 4, core)
        total += ln
    return ref, query


def settings(device, chunk: int) -> dict:
    """The aligner's keyword arguments: the benchmark's settings at this
    chunk size, hit ranges of 16384 rows."""
    return dict(bench_inputs.aligner_settings(device), chunk_size=chunk,
                HBUF=16384)


def measure_farm(ref, query, work, device, chunk, counts) -> dict:
    qrc = revcomp_codes(query)
    rows, want, base = [], None, None
    for nd in counts:
        al = MultiDeviceAligner(num_devices=nd, **settings(device, chunk))
        al.set_ref(ref)
        al.set_query(query, qrc)
        al.map_chunks(work[:2 * nd])   # warm: first launches, allocations
        sync(*al.devices)
        t0 = time.time()
        got = as_tuples(al.map_chunks(work))
        sync(*al.devices)
        dt = time.time() - t0
        if al.errors or al.dead:
            raise RuntimeError(f"{nd} aligners: a worker failed: "
                               f"{al.errors!r}")
        if want is None:
            want, base = got, dt
        elif not same(got, want):
            raise RuntimeError(f"{nd} aligners: output differs from one "
                               f"aligner's")
        rows.append(dict(aligners=nd, wall=dt, speedup=base / dt,
                         efficiency=base / dt / nd,
                         chunks_by=list(al.chunks_by)))
        print(f"aligners={nd}: wall {dt:.3f} s, speedup {base / dt:.2f}, "
              f"efficiency {base / dt / nd:.2f}, chunks by aligner "
              f"{al.chunks_by}", flush=True)
    n = sum(len(r[0]) for r in want)
    print(f"parity: identical (farm, {n} HSPs at every count)", flush=True)
    return dict(rows=rows, want=want, hsps=n)


def measure_split(ref, query, work, device, chunk, want) -> dict:
    job = dict(mode="split", ref=ref, query=query,
               kw={k: v for k, v in settings(device, chunk).items()
                   if k != "device"},
               work=[(w.chunk_start, w.chunk_end, w.rev, w.window)
                     for w in work], runs=1)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        outs = run_workers(job, 2, device, d)
        wall = time.time() - t0
    t0 = time.time()
    got = merge(outs, len(work))
    t_merge = time.time() - t0
    for o in outs:
        print(f"host {o['rank']}: start-up {o['t_init']:.3f} s, set-up "
              f"{o['t_setup']:.3f} s, align {o['walls'][0]:.3f} s, "
              f"{len(o['idx'])} chunk-strands, "
              f"{sum(len(r[0]) for r in o['results'])} HSPs", flush=True)
    print(f"two hosts: wall {wall:.3f} s (spawn to join), merge "
          f"{t_merge * 1e3:.3f} ms", flush=True)
    if not same(got, want):
        raise RuntimeError("two hosts' merged output differs from one "
                           "aligner's")
    print(f"parity: identical (two hosts, "
          f"{sum(len(r[0]) for r in got)} HSPs)", flush=True)
    return dict(wall=wall, merge=t_merge,
                hosts=[{k: o[k] for k in ("t_init", "t_setup", "walls")}
                       for o in outs])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=400_000)
    ap.add_argument("--chunk", type=int, default=32768)
    ap.add_argument("--counts", default="1,2,4")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        require_cuda(PROG)
        print_card(PROG)
    ref, query = make_pair(args.n)
    work = bench_inputs.chunk_work(query, args.chunk)
    print(f"{PROG}: make_pair({args.n}), {len(work)} chunk-strands of "
          f"{args.chunk}, device {args.device}", flush=True)
    print("== farm ==", flush=True)
    farm = measure_farm(ref, query, work, args.device, args.chunk,
                        [int(c) for c in args.counts.split(",")])
    print("== two hosts, round-robin intervals ==", flush=True)
    split = measure_split(ref, query, work, args.device, args.chunk,
                          farm.pop("want"))
    return dict(farm=farm, split=split)


if __name__ == "__main__":
    main(sys.argv[1:])
