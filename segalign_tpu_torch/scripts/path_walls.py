"""Walls of the paths beside the benchmark's cells that run the aligner's
seeding and first windows, for a tree against another in one call.

    python -m segalign_tpu_torch.scripts.path_walls [label [PATH,...]]

Run it from the root of each tree (the package is imported from the
working directory), in turns, with a label naming the tree; PATH names
the paths to run (pair, rm_4M, rm_cli_scale4, b500; all by default). At
the sizes of chip_smoke.py's phases 2c, 3c and 3g:

  pair_one / pair_farm  DeviceAligner.map_chunks over the repeat-1x 4 Mbp
                        pair (bench_inputs), and the same through
                        MultiDeviceAligner, two aligners on the one card:
                        one warm run each, then 8 runs in turns
  rm_4M                 run_repeat_masker on the native route with RMConfig's
                        defaults on the pair's 4 Mbp reference (the table
                        build included), 5 runs
  rm_cli_scale4         the RM CLI through its launcher on scale-4's
                        reference, a process each, 2 runs, with the sha256
                        of its output
  b500_map_chunks       DeviceAligner.map_chunks over block-500 (500 Mbp
                        target, 1 Mbp query), 2 runs after its set-up

Prints the card first and one JSON line a run: its wall on the host clock
(each run ends in a synchronize), its outputs' counts and its
max_memory_allocated.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import torch

from . import print_card, require_cuda
from .. import bench_inputs
from ..config import RMConfig
from ..io.encode import revcomp_codes
from ..parallel.multi import MultiDeviceAligner
from ..pipeline.device import DeviceAligner
from ..pipeline.repeat_masker import run_repeat_masker


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    label = argv[0] if argv else "tree"
    paths = argv[1].split(",") if len(argv) > 1 else [
        "pair", "rm_4M", "rm_cli_scale4", "b500"]
    dev = require_cuda("path_walls")
    card = print_card("path_walls")
    root = os.getcwd()
    d = os.path.join(root, "build", "path_walls")
    os.makedirs(d, exist_ok=True)

    def out(what, wall, **kw):
        print(json.dumps(dict(tree=label, what=what, wall=wall, card=card,
                              **kw)), flush=True)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        r = fn()
        torch.cuda.synchronize()
        return r, time.time() - t0, torch.cuda.max_memory_allocated(dev) / 2**30

    ref, query = bench_inputs.load_inputs()
    qrc = revcomp_codes(query)
    settings = bench_inputs.aligner_settings(dev)
    work = bench_inputs.chunk_work(query)
    depth = bench_inputs.DEPTH
    if "pair" in paths:
        pair_walls(dev, ref, query, qrc, settings, work, depth, timed, out)
    if "rm_4M" in paths:
        rm_walls(d, dev, ref, timed, out)
    if "rm_cli_scale4" in paths:
        rm_cli_walls(d, root, out)
    if "b500" in paths:
        b500_walls(settings, depth, timed, out)


def pair_walls(dev, ref, query, qrc, settings, work, depth, timed, out):
    al = DeviceAligner(**settings)
    al.set_ref(ref)
    al.set_query(query, qrc)
    shared = {k: v for k, v in settings.items() if k != "device"}
    farm = MultiDeviceAligner(device=str(dev), num_devices=2, **shared)
    farm.set_ref(ref, tables=al._host_tables)
    farm.set_query(query, qrc)
    al.map_chunks(work, depth=depth)
    farm.map_chunks(work, depth=depth)
    for who in ("one", "farm", "farm", "one") * 2:
        a = al if who == "one" else farm
        res, dt, peak = timed(lambda: a.map_chunks(work, depth=depth))
        out(f"pair_{who}", dt, hsps=sum(len(r.hsps) for r in res),
            peak_gib=peak)
        if who == "farm" and (farm.errors or farm.dead):
            raise SystemExit(f"path_walls: the farm's aligners "
                             f"{sorted(farm.dead)} failed: {farm.errors!r}")
    del al, farm
    torch.cuda.empty_cache()


def rm_walls(d, dev, ref, timed, out):
    fa = os.path.join(d, "rm_ref.fa")
    bench_inputs.write_codes_fasta(fa, ref)
    cfg = RMConfig(seq_filename=fa)
    for i in range(5):
        od = os.path.join(d, f"rm{i}")
        os.makedirs(od, exist_ok=True)
        for f in os.listdir(od):
            os.remove(os.path.join(od, f))
        st, dt, peak = timed(lambda: run_repeat_masker(
            cfg, od, device=dev, device_seeding=False))
        n_iv = 0
        for f in os.listdir(od):
            if f != "MANIFEST.jsonl":
                with open(os.path.join(od, f)) as fh:
                    n_iv += fh.read().count("\n")
        out("rm_4M", dt, run=i, intervals=n_iv, hits=st.num_seed_hits,
            hsps=st.num_hsps, peak_gib=peak)



def rm_cli_walls(d, root, out):
    r4, q4 = os.path.join(d, "ref4.fa"), os.path.join(d, "qry4.fa")
    bench_inputs.write_scale_inputs("scale-4", r4, q4)
    launcher = os.path.join(root, "segalign_tpu_torch", "scripts",
                            "run_segalign_repeat_masker")
    env = dict(os.environ, PYTHONPATH=root)
    for i in range(2):
        o = os.path.join(d, f"cli{i}.seg")
        t0 = time.time()
        subprocess.run([launcher, r4, "--output", o, "--markend"], env=env,
                       check=True, stdout=subprocess.DEVNULL)
        dt = time.time() - t0
        with open(o, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()
        out("rm_cli_scale4", dt, run=i, sha256=digest)



def b500_walls(settings, depth, timed, out):
    ref5, query5 = bench_inputs.load_inputs(
        *bench_inputs.SCALE_INPUTS["block-500"][:2])
    t0 = time.time()
    al5 = DeviceAligner(**settings)
    al5.set_ref(ref5)
    al5.set_query(query5, revcomp_codes(query5))
    torch.cuda.synchronize()
    out("b500_setup", time.time() - t0)
    work5 = bench_inputs.chunk_work(query5)
    for i in range(2):
        res, dt, peak = timed(lambda: al5.map_chunks(work5, depth=depth))
        out("b500_map_chunks", dt, run=i,
            hsps=sum(len(r.hsps) for r in res),
            hits=sum(r.num_hits for r in res), peak_gib=peak)


if __name__ == "__main__":
    main()
