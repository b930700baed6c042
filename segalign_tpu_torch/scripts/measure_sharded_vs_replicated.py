"""The sharded seed table against the replicated one on one input: the
counterpart of scripts/measure_sharded_vs_replicated.py.

    python -m segalign_tpu_torch.scripts.measure_sharded_vs_replicated
        [--device cuda:0] [--n 600000] [--chunk 250000]

The repeat pair of the benchmark's generators (rng 77, n bases each: a
reference and a query with homology drawn from it), both strands of every
chunk, the benchmark's aligner settings, through

  replicated       MultiDeviceAligner, one aligner, the native route
  sharded S=2, 4   ShardedAligner, the shards in this process
  2 processes      ShardedAligner(group=...), one shard in each of two
                   processes (_scaling_worker, sharded mode): gloo where
                   they share the device, NCCL with a card each

Per row: set-up (aligner, seed table, sequences to the device), the cold
and the warm wall of map_chunks, HSPs, hits and peak device memory (of
each process for the last row, beside the share of a run spent in the
collectives). `--device cuda:0` holds every shard on that card; `--device
cuda` gives each shard and process a card of its own. Every row must give
the replicated row's HSPs, hits and seeds, chunk-strand by chunk-strand:
the script prints `parity: identical` or raises. The device is CUDA unless
`--device cpu` is asked for (the tests' small runs), and without CUDA the
script exits at once.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from . import print_card, require_cuda
from .. import bench_inputs
from ..parallel.multi import MultiDeviceAligner
from ..parallel.sharded import ShardedAligner
from ._scaling_worker import run_workers, same, timed_aligner

PROG = "measure_sharded_vs_replicated"


def repeat_pair(n=600_000):
    """The pair of the benchmark's repeat generators drawn from rng 77."""
    rng = np.random.default_rng(77)
    lib = bench_inputs.make_repeat_library(rng)
    ref = bench_inputs.synth_genome_repeats(rng, n, lib)
    query = bench_inputs.synth_genome_repeats(rng, n, lib, homolog_from=ref)
    return ref, query


def _devices_of(device, S):
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    if dev.index is None:
        return [torch.device("cuda", i) for i in range(S)]
    return [dev]


def _in_process(name, make, ref, query, work, device, S) -> dict:
    r = timed_aligner(make, ref, query, work, _devices_of(device, S))
    return dict(r, name=name, cold=r["walls"][0], warm=r["walls"][1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=600_000)
    ap.add_argument("--chunk", type=int, default=250_000)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        require_cuda(PROG)
        print_card(PROG)
    ref, query = repeat_pair(args.n)
    work = bench_inputs.chunk_work(query, args.chunk)
    kw = dict(bench_inputs.aligner_settings(args.device),
              chunk_size=args.chunk)
    print(f"{PROG}: repeat pair n={args.n}, {len(work)} chunk-strands of "
          f"{args.chunk}, device {args.device}", flush=True)

    rows = [_in_process("replicated",
                        lambda: MultiDeviceAligner(num_devices=1, **kw),
                        ref, query, work, args.device, 1)]
    for S in (2, 4):
        rows.append(_in_process(
            f"sharded S={S}", lambda: ShardedAligner(num_devices=S, **kw),
            ref, query, work, args.device, S))
    job = dict(mode="sharded", ref=ref, query=query, shards=1, runs=2,
               kw={k: v for k, v in kw.items() if k != "device"},
               work=[(w.chunk_start, w.chunk_end, w.rev, w.window)
                     for w in work])
    with tempfile.TemporaryDirectory() as d:
        outs = run_workers(job, 2, args.device, d)
    o = outs[0]
    rows.append(dict(
        name=f"2 processes x 1 shard ({o['backend']}"
             + (", through host memory" if o["host_staged"] else "") + ")",
        setup=max(x["t_setup"] for x in outs),
        cold=max(x["walls"][0] for x in outs),
        warm=max(x["walls"][1] for x in outs), out=o["results"],
        peak_gib=[x["peak_bytes"] / 2**30 for x in outs
                  if x["peak_bytes"] is not None],
        comm_share=[x["comm"][0] / x["comm"][1] for x in outs],
        comm_by=[{k: round(v, 4) for k, v in x["comm"][2].items()}
                 for x in outs],
        start_up=[x["t_init"] for x in outs]))
    if not same(outs[1]["results"], o["results"]):
        raise RuntimeError("the two processes' results differ")

    want = rows[0]["out"]
    for r in rows:
        hsps = sum(len(x[0]) for x in r["out"])
        hits = sum(x[1] for x in r["out"])
        extra = ""
        if "comm_share" in r:
            extra = (f", start-up {[round(t, 3) for t in r['start_up']]} s,"
                     f" collectives {[round(c, 3) for c in r['comm_share']]}"
                     f" of a run's wall (seconds by function "
                     f"{r['comm_by']})")
        mem = (f"{[round(p, 3) for p in r['peak_gib']]} GiB"
               if r["peak_gib"] else "not measured (no card)")
        print(f"{r['name']}: setup {r['setup']:.3f} s, cold {r['cold']:.3f}"
              f" s, warm {r['warm']:.3f} s, hsps {hsps}, hits {hits}, peak "
              f"memory {mem}{extra}", flush=True)
    for r in rows[1:]:
        if not same(r["out"], want):
            raise RuntimeError(f"{r['name']} differs from the replicated "
                               f"table")
    print(f"parity: identical ({sum(len(x[0]) for x in want)} HSPs in "
          f"{len(rows)} rows)", flush=True)
    return dict(rows=[{k: v for k, v in r.items() if k != "out"}
                      for r in rows])


if __name__ == "__main__":
    main(sys.argv[1:])
