"""The native route's programs on cell 1's pair, for a tree against
another in one call; and a summary of a cell's runs on both trees.

    python -m segalign_tpu_torch.scripts.program_walls [label]
    python -m segalign_tpu_torch.scripts.program_walls --summarize FILE...

Run the first form from the root of each tree (the package is imported
from the working directory), in turns P C C P, with a label naming the
tree; a tree without this script takes a copy of it. On the repeat-1x 4
Mbp pair (bench_inputs) with the benchmark's aligner settings, after one
warm pass: the walls of five default passes (each ends in a
synchronize), the host time of each program (the `extend` spans of a
default pass's STAGE_SPANS: on a tree without the program graphs a
program's host steps and its sync, with them its scalar writes and
replay), three serial passes' stages (SEGALIGN_SYNC=1,
SEGALIGN_OVERLAP=0, as the benchmark's per-layer passes), and
max_memory_allocated and memory_reserved over the timed passes. Prints
the card first and one JSON line.

--summarize reads the outputs of `python -m segalign_tpu_torch.bench
--cell NAME` saved as NAME_<label>_<run>.txt (run numbers in the order
the runs were made) and prints, for each cell and label, the values of
query_mbp_per_s in run order, their median and quartiles, the largest
move over three runs in a row (max - min over their median), the peaks,
and for two labels the pairs of runs next to each other in which one
label's value is above the other's. It reads files only, and runs on the
CPU.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time


def measure(label: str) -> dict:
    import numpy as np
    import torch

    from . import print_card, require_cuda
    from .. import bench_inputs
    from ..io.encode import revcomp_codes
    from ..pipeline import device as devmod

    dev = require_cuda("program_walls")
    card = print_card("program_walls")
    ref, query = bench_inputs.load_inputs()
    al = devmod.DeviceAligner(**bench_inputs.aligner_settings(dev))
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    work = bench_inputs.chunk_work(query)
    al.map_chunks(work, depth=bench_inputs.DEPTH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(5):
        t0 = time.time()
        al.map_chunks(work, depth=bench_inputs.DEPTH)
        torch.cuda.synchronize()
        walls.append(round(time.time() - t0, 4))
    devmod.STAGE_SPANS = spans = []
    try:
        al.map_chunks(work, depth=bench_inputs.DEPTH)
    finally:
        devmod.STAGE_SPANS = None
    us = np.array([(end - start) / 1e3 for name, start, end in spans
                   if name == "extend"])
    serial = []
    env = {k: os.environ.get(k) for k in ("SEGALIGN_SYNC",
                                          "SEGALIGN_OVERLAP")}
    os.environ.update(SEGALIGN_SYNC="1", SEGALIGN_OVERLAP="0")
    try:
        for _ in range(3):
            devmod.reset_stage_totals()
            t0 = time.time()
            al.map_chunks(work, depth=bench_inputs.DEPTH)
            serial.append(dict(wall=round(time.time() - t0, 4),
                               **{k: round(v, 4) for k, v in
                                  devmod.STAGE_TOTALS.items()}))
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(label=label, card=card, programs=len(us),
                host_us_median=round(float(np.median(us)), 1),
                host_us_p90=round(float(np.percentile(us, 90)), 1),
                walls_s=walls, serial=serial,
                peak_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30,
                               4),
                reserved_gib=round(torch.cuda.memory_reserved(dev) / 2**30,
                                   4))


def summarize(paths) -> dict:
    """{cell: {label: {...}, "pairs": {...}}} of the cell outputs at
    `paths` (module docstring)."""
    runs: dict = {}
    for path in paths:
        m = re.match(r"(.+)_([^_]+)_(\d+)\.txt$", os.path.basename(path))
        if m is None:
            raise SystemExit(f"program_walls: {path} is not "
                             f"NAME_<label>_<run>.txt")
        with open(path) as f:
            last = json.loads(f.read().strip().splitlines()[-1])
        runs.setdefault(m[1], []).append(
            (int(m[3]), m[2], last["query_mbp_per_s"],
             last["peak_device_gib"], last["correct"]))
    out = {}
    for cell, rs in runs.items():
        rs.sort()
        labels = sorted({r[1] for r in rs})
        cs = {}
        for lab in labels:
            vs = [r[2] for r in rs if r[1] == lab]
            med = statistics.median(vs)
            q = (statistics.quantiles(vs, n=4) if len(vs) > 1
                 else [vs[0]] * 3)
            moves = [(max(vs[i:i + 3]) - min(vs[i:i + 3]))
                     / statistics.median(vs[i:i + 3])
                     for i in range(len(vs) - 2)]
            cs[lab] = dict(values=vs, median=med, quartiles=[q[0], q[2]],
                           largest_3run_move=round(max(moves), 4)
                           if moves else None,
                           peaks_gib=sorted({r[3] for r in rs
                                             if r[1] == lab}),
                           correct=all(r[4] for r in rs if r[1] == lab))
        if len(labels) == 2:
            # runs next to each other, two of the labels: a pair each
            a, b = labels
            wins = {a: 0, b: 0}
            seq = [(r[1], r[2]) for r in rs]
            i = 0
            while i + 1 < len(seq):
                (la, va), (lb, vb) = seq[i], seq[i + 1]
                if la != lb:
                    if va != vb:
                        wins[la if va > vb else lb] += 1
                    i += 2
                else:
                    i += 1
            cs["pairs_won"] = wins
        out[cell] = cs
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--summarize"]:
        print(json.dumps(summarize(argv[1:]), indent=1))
        return
    print(json.dumps(measure(argv[0] if argv else "tree")), flush=True)


if __name__ == "__main__":
    main()
