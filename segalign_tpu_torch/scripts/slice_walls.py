"""Walls and kernel time of the slices chip_smoke.py drives, several runs
each.

    python -m segalign_tpu_torch.scripts.slice_walls [runs]

Six slices, at the sizes of chip_smoke.py's phases 2, 2c, 2b, 2d and 3c:

  native_pair  DeviceAligner.map_chunks over both strands of every 250 kb
               chunk of the repeat-1x 4 Mbp x 4 Mbp pair (bench_inputs)
  farm_pair    the same through MultiDeviceAligner, two aligners on the one
               card
  device_pair  the same on the device-seeding route
  sharded_pair the same through ShardedAligner, four shards on the one card
  rm_native    run_repeat_masker with RMConfig's defaults on the pair's
  rm_device    4 Mbp reference, on either route

For each: one warm run, then `runs` (default 5) runs on the host clock,
each ending in a synchronize, and one more run under torch.profiler for
the device time by kernel (kernel rows only: the profiler lists an
operator's device time again in its aten:: row). Prints the card first and
one JSON line per slice; compare two trees only within one call.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import time

import torch

from . import print_card, require_cuda
from .. import bench_inputs
from ..config import RMConfig
from ..io.encode import revcomp_codes
from ..parallel.multi import MultiDeviceAligner
from ..parallel.sharded import ShardedAligner
from ..pipeline.device import DeviceAligner
from ..pipeline.repeat_masker import run_repeat_masker

TOP = 10   # kernels listed per slice


def _kernel_times(fn):
    """(total device ms, [(kernel name, ms, calls)]) of one run of fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return total, rows[:TOP]


def measure(name, fn, runs, card):
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    total, top = _kernel_times(fn)
    print(json.dumps(dict(
        slice=name, card=card, walls_s=walls,
        median_wall_s=statistics.median(walls), kernel_ms=total,
        top_kernels=[dict(name=k[:60], ms=ms, calls=n)
                     for k, ms, n in top])), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else 5
    if runs < 1:
        raise SystemExit("slice_walls: runs must be at least 1")
    dev = require_cuda("slice_walls")
    card = print_card("slice_walls")
    ref, query = bench_inputs.load_inputs()
    qrc = revcomp_codes(query)
    settings = bench_inputs.aligner_settings(dev)
    work = bench_inputs.chunk_work(query)

    al = DeviceAligner(**settings)
    al.set_ref(ref)
    al.set_query(query, qrc)
    tables = al._host_tables
    measure("native_pair",
            lambda: al.map_chunks(work, depth=bench_inputs.DEPTH), runs, card)
    del al
    for name, make, kw in (
            ("farm_pair", lambda: MultiDeviceAligner(
                **settings, num_devices=2), dict(depth=bench_inputs.DEPTH)),
            ("device_pair", lambda: DeviceAligner(
                **settings, device_seeding=True), {}),
            ("sharded_pair", lambda: ShardedAligner(
                **settings, num_devices=4), {})):
        al = make()
        al.set_ref(ref, tables=tables)
        al.set_query(query, qrc)
        measure(name, lambda: al.map_chunks(work, **kw), runs, card)
        del al
        torch.cuda.empty_cache()

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    d = os.path.join(root, "build", "slice_walls")
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "rm_ref.fa")
    bench_inputs.write_codes_fasta(fa, ref)
    cfg = RMConfig(seq_filename=fa)

    def rm(route):
        out_dir = os.path.join(d, f"rm_{route}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        run_repeat_masker(cfg, out_dir, device=dev,
                          device_seeding=route == "device")

    for route in ("native", "device"):
        measure(f"rm_{route}", lambda: rm(route), runs, card)


if __name__ == "__main__":
    main()
