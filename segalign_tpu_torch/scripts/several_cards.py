"""The port on several cards of one machine, held to one card: what only a
machine with several cards shows.

    python -m segalign_tpu_torch.scripts.several_cards [--cards N]
        [--mbp 4] [--device cuda]

On bench_inputs' repeat-1x pair (mbp x mbp, rng 2024; 8351 HSPs at 4 Mbp)
with the benchmark's settings:

  one card      DeviceAligner on one device, native and device-seeding
                routes: the arrays every other row must equal
  farm          MultiDeviceAligner with N aligners, a card each, both routes
  shards        ShardedAligner with N shards, a card each
  N processes   ShardedAligner(group=...) across N processes, a card and a
                shard each, over NCCL (_scaling_worker, sharded mode)

Each row gives the wall of two runs after set-up (cold, warm), peak memory
a card, and its parity with one card, chunk-strand by chunk-strand (HSPs,
hits and seeds); the last row also each process's share of a run spent in
the collectives. Then both CLIs on the pair written as FASTA (the pairwise
CLI on both, the repeat masker on the reference), one device against
`--num_devices N`, with and without `--sharded_table`: each output byte
for byte equal to one device's, with each process's wall.

`--device cuda` (the default) takes cuda:0..N-1 and needs N cards (N: all
of them unless --cards says); `--device cpu` runs the same layout on the
CPU (every aligner, shard and process there, gloo), which rehearses the
N-process path without a card and measures nothing. Prints `parity:
identical` at the end or raises.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch

from . import print_card, require_cuda
from .. import bench_inputs
from ..parallel.multi import MultiDeviceAligner
from ..parallel.sharded import ShardedAligner
from ..pipeline.device import DeviceAligner
from ._scaling_worker import ROOT, run_workers, same, timed_aligner

PROG = "several_cards"


def _row(name, make, ref, query, work, devs, want) -> dict:
    """Set-up and two timed runs of one aligner; fails unless its results
    equal `want` (when given)."""
    r = timed_aligner(make, ref, query, work, devs)
    if want is not None and not same(r["out"], want):
        raise RuntimeError(f"{name} differs from one card")
    mem = (f"{[round(p, 3) for p in r['peak_gib']]} GiB" if devs
           else "not measured (no card)")
    print(f"{name}: set-up {r['setup']:.3f} s, walls {r['walls'][0]:.3f} "
          f"and {r['walls'][1]:.3f} s, "
          f"{sum(len(x[0]) for x in r['out'])} HSPs, peak memory {mem}",
          flush=True)
    return dict(r, name=name)


def _cli(module, argv, cwd, out) -> tuple:
    """(bytes of the output, seconds) of one CLI process."""
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", f"segalign_tpu_torch.cli.{module}", *argv,
         "--output", out, "--markend"], cwd=cwd, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT), timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{module} {argv} exited {r.returncode}:\n"
                           f"{r.stderr[-3000:]}")
    if "after device failure" in r.stderr:
        raise RuntimeError(f"{module} {argv} retried chunks:\n"
                           f"{r.stderr[-3000:]}")
    with open(out, "rb") as f:
        data = f.read()
    os.remove(out)
    return data, time.time() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split(
        "\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cards", type=int, default=-1)
    ap.add_argument("--mbp", type=float, default=4.0)
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card:
        require_cuda(PROG)
        print_card(PROG)
        n = torch.cuda.device_count() if args.cards <= 0 else args.cards
        if n < 2 or n > torch.cuda.device_count():
            raise SystemExit(f"{PROG}: needs 2 to "
                             f"{torch.cuda.device_count()} cards, not {n}")
        one = "cuda:0"
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        n = max(args.cards, 2)
        one, devs = "cpu", []
    ref, query = bench_inputs.load_inputs(args.mbp, args.mbp)
    work = bench_inputs.chunk_work(query)
    kw = {k: v for k, v in bench_inputs.aligner_settings(one).items()
          if k != "device"}
    print(f"{PROG}: repeat-1x pair {args.mbp} Mbp x {args.mbp} Mbp, "
          f"{len(work)} chunk-strands, {n} devices ({args.device})",
          flush=True)

    rows = [_row("one card, native route",
                 lambda: DeviceAligner(device=one, **kw), ref, query, work,
                 devs[:1], None)]
    want = rows[0]["out"]
    rows.append(_row("one card, device route",
                     lambda: DeviceAligner(device=one, device_seeding=True,
                                           **kw), ref, query, work,
                     devs[:1], want))
    for ds in (False, True):
        rows.append(_row(
            f"farm, {n} aligners, {'device' if ds else 'native'} route",
            lambda: MultiDeviceAligner(device=args.device, num_devices=n,
                                       device_seeding=ds, **kw),
            ref, query, work, devs, want))
    rows.append(_row(f"shards, {n} in one process",
                     lambda: ShardedAligner(device=args.device,
                                            num_devices=n, **kw),
                     ref, query, work, devs, want))
    job = dict(mode="sharded", ref=ref, query=query, shards=1, runs=2,
               kw=kw, work=[(w.chunk_start, w.chunk_end, w.rev, w.window)
                            for w in work])
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        outs = run_workers(job, n, args.device, d)
        spawn = time.time() - t0
    for o in outs:
        if not same(o["results"], want):
            raise RuntimeError(f"process {o['rank']} of {n} differs from "
                               f"one card")
        if on_card and min(o["launches"].values()) == 0:
            raise RuntimeError(f"process {o['rank']} launched no "
                               f"{o['launches']}")
    procs = dict(
        name=f"{n} processes x 1 shard ({outs[0]['backend']})",
        spawn_to_join=spawn, start_up=[o["t_init"] for o in outs],
        setup=[o["t_setup"] for o in outs],
        walls=[o["walls"] for o in outs],
        peak_gib=[o["peak_bytes"] / 2**30 for o in outs
                  if o["peak_bytes"] is not None],
        comm_share=[o["comm"][0] / o["comm"][1] for o in outs],
        comm_by=[{k: round(v, 4) for k, v in o["comm"][2].items()}
                 for o in outs],
        launches=[o["launches"] for o in outs])
    walls = [[round(w, 3) for w in x] for x in procs["walls"]]
    print(f"{procs['name']}: walls {walls} s, start-up "
          f"{[round(t, 3) for t in procs['start_up']]} s, "
          f"set-up {[round(t, 3) for t in procs['setup']]} s, collectives "
          f"{[round(c, 3) for c in procs['comm_share']]} of a run's wall "
          f"(seconds by function {procs['comm_by']}), "
          f"peak memory {[round(p, 3) for p in procs['peak_gib']]} GiB, "
          f"launches {procs['launches']}; every process equal to one card",
          flush=True)

    clis = []
    with tempfile.TemporaryDirectory() as d:
        bench_inputs.write_codes_fasta(os.path.join(d, "ref.fa"), ref)
        bench_inputs.write_codes_fasta(os.path.join(d, "query.fa"), query,
                                       "query")
        out = os.path.join(d, "out")
        many = ["--device", args.device, "--num_devices", str(n)]
        for module, inputs, extra in (
                ("run_segalign", ["ref.fa", "query.fa"], ["--nogapped"]),
                ("run_segalign_repeat_masker", ["ref.fa"], [])):
            base = None
            for label, flags in (("one device", ["--device", one]),
                                 (f"{n} devices", many),
                                 (f"{n} shards", [*many, "--sharded_table"])):
                data, secs = _cli(module, [*inputs, *extra, *flags], d, out)
                if base is None:
                    base = data
                elif data != base:
                    raise RuntimeError(f"{module} with {label} differs from "
                                       f"one device")
                clis.append(dict(cli=module, mode=label, seconds=secs,
                                 lines=data.count(b"\n")))
                print(f"{module}, {label}: {data.count(b'\n')} lines in "
                      f"{secs:.1f} s", flush=True)
    print(f"parity: identical ({sum(len(r[0]) for r in want)} HSPs in "
          f"{len(rows) + 1} aligner rows; both CLIs byte for byte)",
          flush=True)
    return dict(rows=[{k: v for k, v in r.items() if k != "out"}
                      for r in rows], processes=procs, clis=clis)


if __name__ == "__main__":
    main(sys.argv[1:])
