"""Worker processes of the scaling scripts (measure_scaling.py,
measure_sharded_vs_replicated.py, several_cards.py) and of chip_smoke.py
phase 2e: one of `world` processes that align one set of inputs.

    python -m segalign_tpu_torch.scripts._scaling_worker JOB RANK

JOB is a pickle that run_workers wrote: the inputs (reference, query, the
aligner's keyword arguments, the chunk-strands), the mode and the layout of
the processes. Two modes:

  split    the two-host interval split (parallel/distributed.py): a
           DeviceAligner aligns this rank's round-robin share of the
           query's intervals (an interval here is one chunk, both strands);
           the ranks join no group and nothing passes between them
  sharded  the seed table sharded across the processes: the ranks join a
           torch.distributed group (gloo where they share a device, NCCL
           where each has a card of its own) and run one
           ShardedAligner(group=...) over every chunk-strand

A rank writes what it measured to JOB.RANK.out, a pickle: its results (by
index of chunk-strand), its walls (start-up to the group, set-up, each
run), peak device memory and the K2 and K5 launches of its first run, and
in the sharded mode the seconds of one more run spent in the collectives.
Every run after the first must give the first run's results. Importing
this module starts nothing.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..io.encode import revcomp_codes
from ..ops.gather import gather_rows
from ..ops.window_scan_wide import window_scan_wide
from ..parallel import sharded
from ..parallel.distributed import partition_intervals, process_group
from ..parallel.multi import ChunkWork
from ..pipeline.device import DeviceAligner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def sync(*devs: torch.device):
    for dev in devs:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def as_tuples(results) -> list:
    """(hsps, num_hits, num_seeds) of each ChunkResult."""
    return [(r.hsps, r.num_hits, r.num_seeds) for r in results]


def same(got, want) -> bool:
    """Equal (hsps, num_hits, num_seeds) for every chunk-strand."""
    return len(got) == len(want) and all(
        a[1:] == b[1:] and np.array_equal(a[0], b[0])
        for a, b in zip(got, want))


def timed_aligner(make, ref, query, work, devs, runs: int = 2) -> dict:
    """An aligner from make() set up on the pair, then `runs` map_chunks
    over work, each timed to a synchronize of `devs`: set-up and run walls
    (s), the results, and peak device memory a device (GiB). A run that
    differs from the first raises."""
    devs = [torch.device(d) for d in devs]
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.time()
    al = make()
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    sync(*devs)
    setup, walls, out = time.time() - t0, [], None
    for run in range(runs):
        t0 = time.time()
        got = as_tuples(al.map_chunks(work))
        sync(*devs)
        walls.append(time.time() - t0)
        if out is None:
            out = got
        elif not same(got, out):
            raise RuntimeError(f"run {run} differs from run 0")
    if getattr(al, "errors", None):
        raise RuntimeError(f"a farm worker failed: {al.errors!r}")
    return dict(setup=setup, walls=walls, out=out, peak_gib=[
        torch.cuda.max_memory_allocated(d) / 2**30 for d in devs])


def layout(device, world: int):
    """(the device each worker names, the backend of the sharded mode, a
    card a worker): `cuda` gives each worker a card of its own
    (CUDA_VISIBLE_DEVICES) and NCCL; `cpu` or `cuda:K` holds every worker
    and gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if have < world:
            raise RuntimeError(f"{world} workers with a card each need "
                               f"{world} CUDA devices; this machine has "
                               f"{have}")
        return "cuda:0", "nccl", True
    return str(dev), "gloo", False


def run_workers(job: dict, world: int, device, workdir: str,
                timeout: float = 900) -> List[dict]:
    """Run `world` workers on `job` (mode, ref, query, kw, work, runs and,
    for the sharded mode, shards a worker) and return what each wrote, in
    rank order. A worker that fails or outlives `timeout` fails the call;
    every worker is ended before it returns."""
    name, backend, own_card = layout(device, world)
    if torch.device(name).type == "cuda":
        from .. import _build
        _build.kernels()   # build once here, not in every worker
    os.makedirs(workdir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = os.path.join(workdir, f"job_{job['mode']}.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(job, world=world, device=name, backend=backend,
                         port=port, spawned=time.time()), f)
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                       NCCL_SOCKET_IFNAME="lo",
                       PYTHONPATH=os.pathsep.join(
                           p for p in [ROOT, os.environ.get("PYTHONPATH")]
                           if p))
            if own_card:
                env["CUDA_VISIBLE_DEVICES"] = str(rank)
            elif torch.device(name).type == "cpu":
                # workers on the CPU share its cores
                env["OMP_NUM_THREADS"] = str(max(
                    1, (os.cpu_count() or 1) // world))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, path, str(rank)], env=env,
                cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        deadline = time.time() + timeout
        logs = [p.communicate(timeout=max(deadline - time.time(), 1))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, logs[r][1][-3000:])
              for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{job['mode']} workers failed: {failed}")
    outs = []
    for rank in range(world):
        with open(f"{path}.{rank}.out", "rb") as f:
            outs.append(dict(pickle.load(f), log=logs[rank][1]))
    return outs


def merge(outs: List[dict], n: int) -> list:
    """The split mode's results in work order: (hsps, num_hits, num_seeds)
    of every chunk-strand, each from the one rank that aligned it."""
    results = [None] * n
    for out in outs:
        for i, r in zip(out["idx"], out["results"]):
            if results[i] is not None:
                raise RuntimeError(f"chunk-strand {i} aligned twice")
            results[i] = r
    if any(r is None for r in results):
        raise RuntimeError("a chunk-strand was aligned by no rank")
    return results


def _timed_collectives(fn, dev):
    """Run fn with sharded.py's collectives timed on the host clock, each
    between two synchronizes: (seconds in them, seconds of fn, seconds by
    function: the size matrix's all_gather, the two exchanges, the two
    gathers)."""
    names = ("exchange", "gather_to", "_all_gather")
    saved = {k: getattr(sharded, k) for k in names}
    spent = dict.fromkeys(names, 0.0)
    depth = [0]

    def wrap(name, f):
        def timed(*args, **kw):
            if depth[0] == 0:
                sync(dev)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return f(*args, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    sync(dev)
                    spent[name] += time.perf_counter() - t0
        return timed

    for k, f in saved.items():
        setattr(sharded, k, wrap(k, f))
    try:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        return sum(spent.values()), time.perf_counter() - t0, spent
    finally:
        for k, f in saved.items():
            setattr(sharded, k, f)


def main(argv: List[str]) -> None:
    path, rank = argv[0], int(argv[1])
    with open(path, "rb") as f:
        job = pickle.load(f)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = None
    if job["mode"] == "sharded":
        dist.init_process_group(
            job["backend"], init_method=f"tcp://127.0.0.1:{job['port']}",
            rank=rank, world_size=job["world"])
        group = process_group()
    # from the launcher's spawn: the interpreter, the imports, the group
    t_init = time.time() - job["spawned"]

    ref, query = job["ref"], job["query"]
    work = [ChunkWork(*w) for w in job["work"]]
    idx = list(range(len(work)))
    if job["mode"] == "split":
        chunks = sorted({(w.chunk_start, w.chunk_end) for w in work})
        mine = set(partition_intervals(chunks, rank, job["world"]))
        idx = [i for i, w in enumerate(work)
               if (w.chunk_start, w.chunk_end) in mine]
    my_work = [work[i] for i in idx]

    t0 = time.time()
    if job["mode"] == "split":
        al = DeviceAligner(device=dev, **job["kw"])
    else:
        al = sharded.ShardedAligner(device=dev, num_devices=job["shards"],
                                    group=group, **job["kw"])
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    sync(dev)
    t_setup = time.time() - t0

    walls, first, launches, peak = [], None, None, None
    for run in range(job["runs"]):
        if group is not None:
            dist.barrier(group=group)
        if run == 0:
            gather_rows.launches = window_scan_wide.launches = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        got = as_tuples(al.map_chunks(my_work))
        sync(dev)
        walls.append(time.time() - t0)
        if run == 0:
            first = got
            launches = dict(gather_rows=gather_rows.launches,
                            window_scan_wide=window_scan_wide.launches)
            if dev.type == "cuda":
                peak = torch.cuda.max_memory_allocated(dev)
        elif not same(got, first):
            raise RuntimeError(f"rank {rank}: run {run} differs from run 0")
    comm = None
    if group is not None:
        dist.barrier(group=group)
        comm = _timed_collectives(lambda: al.map_chunks(my_work), dev)
    out = dict(rank=rank, idx=idx, results=first, t_init=t_init,
               t_setup=t_setup, walls=walls, launches=launches,
               peak_bytes=peak, comm=comm, backend=job["backend"],
               host_staged=getattr(al, "host_staged", False),
               shards=getattr(al, "S", 1))
    with open(f"{path}.{rank}.out", "wb") as f:
        pickle.dump(out, f)
    print(f"rank {rank}: init {t_init:.3f} s, set-up {t_setup:.3f} s, walls "
          f"{[round(w, 3) for w in walls]} s, {len(my_work)} chunk-strands",
          file=sys.stderr, flush=True)
    if group is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
