"""Benchmark of the port: ungapped seed-filter-extend throughput on one
device.

Counterpart of the root bench.py, the JAX package's benchmark, which stays
as it is: the same inputs (bench_inputs.py), the same passes over them and
the same last line, with the port's DeviceAligner on a CUDA device.

    python -m segalign_tpu_torch.bench [--device cuda]

Runs the repeat-1x pair (4 Mbp x 4 Mbp) cold, then BENCH_STEADY_REPS
steady passes (the best is the headline), a serial pass that synchronizes
after every device stage (the stage breakdown), the native gapped stage
over the steady pass's HSPs and a pass with the gapped stage overlapping
the ungapped one, the 0.5x and 4x density sweep (2 Mbp) and legacy-planted
(4 Mbp), each cold and steady, and the engine parity (one chunk-strand at
first-window widths 512 and 256). Each pass prints a `bench[label]:` line
to stderr in the JAX bench's form (seeds, hits, HSPs, hits/Mbp, Mbp/s),
after a `cell[label]:` line with what the port can tell and the TPU could
not: the kernels' launches in the pass and, on a card, the pass's peak
device memory (a cold pass's includes its set-up). The build time of the
kernels and the native library is printed first, apart from cold_s.

Prints ONE json line to stdout, last, with the JAX bench's keys and
meanings: metric, value (steady Mbp/s of query, repeat-1x), unit,
vs_baseline, cold_s (the cold pass's timed loop), densities (Mbp/s and
hits/Mbp by repeat content), engine_parity, kernel_fraction and breakdown
(the serial pass's stages), e2e_overlapped_mbps, legacy_planted_mbps.

Env, as in the JAX bench: BENCH_REF_FASTA / BENCH_QUERY_FASTA real inputs;
BENCH_REF_MBP / BENCH_QUERY_MBP sizes; BENCH_SWEEP=0 / BENCH_LEGACY=0 /
BENCH_VERIFY=0 skip the extra sections (BENCH_VERIFY=full adds the
device-seeding route to the engine parity); BENCH_STEADY=0 makes the cold
pass the headline; BENCH_STEADY_REPS steady passes (3); BENCH_BREAKDOWN=0
skips the serial pass; SEGALIGN_BENCH_GAPPED=0 skips the gapped stage,
BENCH_GAPPED_MAX caps its segments (20000); BENCH_SAVE_HSPS=path.npz saves
each pass's HSP arrays, one per chunk-strand with HSPs.

One cell of the benchmark the repository records (BENCHMARK.json, which
defines each cell as data; bench_cells.py reads it):

    python -m segalign_tpu_torch.bench --cell NAME [--seed N] [--device cuda]

builds the kernels and the native library, runs the cell's timed passes
(each one's wall and CPU seconds, the card and the host on either side of
them; a pair cell's in its `processes` fresh processes one after another,
each this module with --worker on the pair this process drew: its cold
pass, its timed passes, each thread's CPU seconds and how long each of
its phases took), three more passes under SEGALIGN_SYNC=1 (each stage's
seconds, the median of the three, and each kernel's launches) and one
under torch.profiler (the device's busy share, each kernel's device time
and launches, the device time each host stage queued, the busiest ops, the
longest idle gaps named by the host's stage), prints each metric and each
per-layer metric of BENCHMARK.json by name with its unit, the profile's
breakdown, a detail line and, last, the result: {cell, seed, correct,
each metric, units, layers, layer_units, breakdown, device}. It exits 1
when the output fails the cell's gate (run_cell): at seed 2024 the JAX
package's counts and HSPs, at every seed a plain rescoring of each HSP;
and when the JAX side of the repo was loaded into the run or into one of
its processes; a process that fails or prints no result fails the cell
with no result line (cell_main). --benchmark runs a cell of another copy
of the file (another form of a cell, to measure it).

There is no fallback: with --device cuda and no card the bench exits
non-zero, and a kernel that fails to build or launch fails the run.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import hashlib
import json
import os
import re
import resource
import shlex
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import _build, bench_cells, bench_inputs
from .bench_inputs import CHUNK, DEPTH
from .config import build_substitution_matrix
from .io.encode import encode, revcomp_codes
from .io.fasta import read_fasta
from .native import gapped_extend_native
from .ops.launches import launch_counts
from .pipeline import device as devmod
from .pipeline.device import DeviceAligner

# The JAX bench's fixed yardstick: an ESTIMATE of SegAlign's ungapped
# throughput on one NVIDIA V100, derived from the SC20 paper's end-to-end
# speedups over lastz (the reference publishes no number). Not a TPU
# figure and not a measurement; vs_baseline is value / this.
NOMINAL_V100_MBPS = 2.0

def load_inputs(ref_mbp: float, query_mbp: float):
    """The repeat-1x pair by default; real FASTA through BENCH_REF_FASTA /
    BENCH_QUERY_FASTA (every record of each, concatenated)."""
    ref_fa = os.environ.get("BENCH_REF_FASTA")
    query_fa = os.environ.get("BENCH_QUERY_FASTA")
    if ref_fa and query_fa:
        ref = np.concatenate([encode(s) for _, s in read_fasta(ref_fa)])
        query = np.concatenate([encode(s)
                                for _, s in read_fasta(query_fa)])
        print(f"bench inputs: {ref_fa} ({len(ref)/1e6:.1f} Mbp) x "
              f"{query_fa} ({len(query)/1e6:.1f} Mbp)", file=sys.stderr)
        return ref, query
    return bench_inputs.load_inputs(ref_mbp, query_mbp)


def make_aligner(device, chunk_size: int = CHUNK, **kw) -> DeviceAligner:
    """A DeviceAligner with the benchmark's settings on `device`; kw (window,
    device_seeding) goes to the constructor."""
    settings = bench_inputs.aligner_settings(device)
    settings["chunk_size"] = chunk_size
    return DeviceAligner(**settings, **kw)


def run_config(ref, query, label, device, al=None, qrc=None,
               skip_setup=False):
    """Align one pair end to end; returns a result dict (mbps, hit
    density, wall, counts, the HSP batches for the gapped stage, the
    kernels' launches and the pass's peak device memory).

    skip_setup reuses an aligner whose ref/query state is already set (a
    steady re-run of the same pair: kernels built, sequences and seed table
    resident)."""
    if qrc is None:
        qrc = revcomp_codes(query)
    if al is None:
        al = make_aligner(device)
    cuda = al.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(al.device)
    table_s = 0.0
    q_len = len(query) - al.seed_size
    if not skip_setup:
        t0 = time.time()
        al.set_ref(ref)
        table_s = time.time() - t0
        al.set_query(query, qrc)
        # warmup, as in the JAX bench (there it compiled the first chunks)
        al.seed_and_filter(0, min(CHUNK, q_len), rev=False)
        al.seed_and_filter(0, min(CHUNK, q_len), rev=True)
    work = bench_inputs.chunk_work(query)
    before = launch_counts()
    t1 = time.time()
    stats = dict(hsps=0, hits=0, seeds=0)
    results = al.map_chunks(work, depth=DEPTH)
    for r in results:
        stats["hsps"] += len(r.hsps)
        stats["hits"] += r.num_hits
        stats["seeds"] += r.num_seeds
    dt = time.time() - t1
    launches = launch_counts(before)
    peak = torch.cuda.max_memory_allocated(al.device) if cuda else None
    n_query = len(query)
    mbps = (n_query / 1e6) / dt
    dens = stats["hits"] / (n_query / 1e6)
    dump = os.environ.get("BENCH_SAVE_HSPS")
    if dump:
        np.savez(dump, **bench_cells.named_hsps(results, work))
    mem = ("" if peak is None
           else f", max_memory_allocated {peak / 2**30:.3f} GiB")
    print(f"cell[{label}]: launches {json.dumps(launches)}{mem}",
          file=sys.stderr, flush=True)
    print(f"bench[{label}]: {n_query/1e6:.0f} Mbp query vs "
          f"{len(ref)/1e6:.0f} Mbp ref in {dt:.2f}s (+{table_s:.2f}s "
          f"table) | seeds={stats['seeds']} hits={stats['hits']} "
          f"hsps={stats['hsps']} ({dens:.2g} hits/Mbp) -> "
          f"{mbps:.3f} Mbp/s", file=sys.stderr, flush=True)
    return dict(mbps=mbps, density=dens, dt=dt, stats=stats,
                batches=[(r.hsps, w.rev) for r, w in zip(results, work)
                         if len(r.hsps)], qrc=qrc, al=al, launches=launches,
                peak_bytes=peak)


def bench_gapped_overlap(ref, query, qrc, al, sub8x8):
    """End-to-end pass with the gapped stage OVERLAPPING the ungapped
    pipeline, with the anchor-interference filter of
    output/native_gapped.py (an anchor inside an accepted alignment's box
    is skipped, as lastz discards covered anchors).

    DP jobs start as chunks finish (map_chunks' on_result), on host
    threads, as the reference's run_segalign script runs lastz while
    segalign still runs. Each batch's jobs enqueue score-descending; every
    worker re-checks coverage right before its DP and indexes acceptances
    right after: a parallel schedule of the same filter, so concurrent
    anchors may both run where the serial order would skip one, and the DP
    and skip counts vary from run to run."""
    work = bench_inputs.chunk_work(query)
    cap = int(os.environ.get("BENCH_GAPPED_MAX", "20000"))
    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
    lock = threading.Lock()
    SHIFT = 14
    index = {False: ([], {}), True: ([], {})}  # items, r-bucket dict
    stats = dict(dp=0, skip=0, acc=0, seen=0)
    futs = []

    def covered(rev, mr, mq):
        items, buckets = index[rev]
        for i in buckets.get(mr >> SHIFT, ()):
            r0, r1, q0, q1 = items[i]
            if r0 <= mr < r1 and q0 <= mq < q1:
                return True
        return False

    def add(rev, box):
        items, buckets = index[rev]
        i = len(items)
        items.append(box)
        for b in range(box[0] >> SHIFT,
                       (max(box[1] - 1, box[0]) >> SHIFT) + 1):
            buckets.setdefault(b, []).append(i)

    def one(rev, mid_r, mid_q):
        with lock:
            if covered(rev, mid_r, mid_q):
                stats["skip"] += 1
                return
            stats["dp"] += 1
        r = gapped_extend_native(ref, qrc if rev else query, sub8x8,
                                 400, 30, 9430, mid_r, mid_q)
        if r is not None and r[0] >= 3000:
            with lock:
                stats["acc"] += 1
                add(rev, (r[1], r[3], r[2], r[4]))

    def on_result(i, res):
        rev = work[i].rev
        jobs = sorted(((int(sc), int(rs + ln // 2), int(qs + ln // 2))
                       for rs, qs, ln, sc in res.hsps), reverse=True)
        for _, mr, mq in jobs:
            if stats["seen"] < cap:
                stats["seen"] += 1
                futs.append(pool.submit(one, rev, mr, mq))

    t0 = time.time()
    try:
        al.map_chunks(work, depth=DEPTH, on_result=on_result)
        t_ungapped = time.time() - t0
        for f in futs:
            f.result()
    finally:
        pool.shutdown(wait=True)
    t_total = time.time() - t0
    e2e = (len(query) / 1e6) / t_total
    print(f"e2e[overlapped+interference]: ungapped {t_ungapped:.2f}s, "
          f"+gapped drain {t_total - t_ungapped:.2f}s = {t_total:.2f}s "
          f"total ({stats['dp']} DPs, {stats['skip']} skipped, "
          f"{stats['acc']} accepted) -> {e2e:.3f} Mbp/s",
          file=sys.stderr, flush=True)
    return e2e


def bench_gapped(ref, q_fw, q_rc, hsp_batches, sub8x8, ungapped_dt):
    """Native ydrop gapped stage over the ungapped stage's output: one DP
    extension per final HSP, anchored at its midpoint, on os.cpu_count()
    host threads (the reference runs at most nproc lastz processes).
    HSP-dense inputs are SAMPLED (BENCH_GAPPED_MAX, default 20000
    segments) and the end-to-end number extrapolates the measured
    segments/s, printed as such."""
    jobs = []
    for hsps, rev in hsp_batches:
        q = q_rc if rev else q_fw
        for rs, qs, ln, sc in hsps:
            jobs.append((q, int(rs + ln // 2), int(qs + ln // 2)))
    n_all = len(jobs)
    cap = int(os.environ.get("BENCH_GAPPED_MAX", "20000"))
    if n_all > cap:
        idx = np.linspace(0, n_all - 1, cap).astype(int)
        jobs = [jobs[i] for i in idx]
    t0 = time.time()

    def one(j):
        q, mid_r, mid_q = j
        r = gapped_extend_native(ref, q, sub8x8, 400, 30, 9430,
                                 mid_r, mid_q)
        return r is not None and r[0] >= 3000

    # ctypes releases the GIL during the DP
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        nacc = sum(ex.map(one, jobs))
    g_s = time.time() - t0
    g_full = g_s * n_all / max(len(jobs), 1)
    e2e = (len(q_fw) / 1e6) / (ungapped_dt + g_full)
    note = (f" [sampled {len(jobs)}/{n_all}, extrapolated]"
            if n_all > len(jobs) else "")
    print(f"gapped stage (native ydrop): {len(jobs)} segments in "
          f"{g_s:.2f}s ({len(jobs)/max(g_s,1e-9):.0f} segments/s, "
          f"{nacc} accepted) | end-to-end {e2e:.3f} Mbp/s{note}",
          file=sys.stderr, flush=True)


def engine_parity(ref, query, qrc, device):
    """One chunk-strand of the first 1 Mbp on the native route at two
    first-window widths, 512 and 256: outputs must not depend on the
    window decomposition, and the two widths run K1 and K3 at different
    shapes. BENCH_VERIFY=full adds the device-seeding route (the JAX
    bench's XLA engine has no counterpart in the port). Returns
    'identical:...' / 'MISMATCH:<detail>' / 'skipped:<why>', a recorded
    string, not an assertion (the CPU tests hold the widths and routes
    equal per commit). An exception is not recorded: it means a kernel
    failed to build or launch, and the bench fails."""
    mode = os.environ.get("BENCH_VERIFY", "1")
    if mode == "0":
        return "skipped:BENCH_VERIFY=0"
    engines = [("row", {}), ("roww256", {"window": 256})]
    if mode == "full":
        engines.append(("device", {"device_seeding": True}))
    outs = {}
    for name, kw in engines:
        al = make_aligner(device, **kw)
        al.set_ref(ref[:1_000_000])
        al.set_query(query[:1_000_000], qrc[-1_000_000:])
        before = launch_counts()
        outs[name] = al.seed_and_filter(0, CHUNK, rev=False).hsps
        print(f"cell[parity-{name}]: launches "
              f"{json.dumps(launch_counts(before))}", file=sys.stderr,
              flush=True)
    base = outs["row"]
    names = [n for n, _ in engines[1:]]
    for name in names:
        if base.shape != outs[name].shape or \
                not np.array_equal(base, outs[name]):
            return (f"MISMATCH:row-vs-{name} "
                    f"{base.shape}!={outs[name].shape}")
    print(f"engine parity: row=={'=='.join(names)} over 1 "
          f"chunk-strand ({len(base)} HSPs)", file=sys.stderr, flush=True)
    return f"identical:{'+'.join(['row'] + names)}:{len(base)}hsps"


def run_breakdown(ref, query, res):
    """Serial re-run of the headline pair with a synchronize after every
    device stage (SEGALIGN_SYNC=1) and no finisher thread
    (SEGALIGN_OVERLAP=0): every stage time is a blocking measurement
    (asynchronous launches hide device time inside the fetch otherwise).
    Returns the stage dict with the run's wall; kernel_fraction = the
    extension's time / the serial wall."""
    devmod.reset_stage_totals()
    with _env(SEGALIGN_SYNC="1", SEGALIGN_OVERLAP="0"):
        r = run_config(ref, query, "repeat-1x-serial", res["al"].device,
                       al=res["al"], qrc=res["qrc"], skip_setup=True)
    totals = dict(devmod.STAGE_TOTALS)
    stages = {k: round(v, 3) for k, v in totals.items()}
    covered = sum(totals.values())
    wall = r["dt"]
    kf = totals.get("extend", 0.0) / max(wall, 1e-9)
    print(f"breakdown[serial-sync]: wall={wall:.2f}s covered="
          f"{covered:.2f}s ({100*covered/max(wall,1e-9):.0f}%) "
          f"kernel_fraction={kf:.2f} stages={stages}",
          file=sys.stderr, flush=True)
    return dict(stages=stages, serial_wall=round(wall, 2),
                covered_frac=round(covered / max(wall, 1e-9), 3),
                kernel_fraction=round(kf, 3))


def _steady(ref, query, label, res, reps):
    """`reps` steady passes; the best (least wall) is the result, and the
    median and spread of the walls go to stderr (walls spread on the host
    clock)."""
    best, dts = None, []
    for _ in range(reps):
        cur = run_config(ref, query, label, res["al"].device, al=res["al"],
                         qrc=res["qrc"], skip_setup=True)
        dts.append(cur["dt"])
        if best is None or cur["dt"] < best["dt"]:
            best = cur
    med = float(np.median(dts))
    mbps = len(query) / 1e6 / np.array(dts)
    print(f"steady[{label}]: {reps} passes, walls {min(dts):.3f} best, "
          f"{med:.3f} median, {max(dts):.3f} worst s (spread "
          f"{100 * (max(dts) - min(dts)) / med:.1f}% of the median) -> "
          f"{mbps.max():.3f} best, {float(np.median(mbps)):.3f} median "
          f"Mbp/s", file=sys.stderr, flush=True)
    return best


# ---- one cell of the benchmark (BENCHMARK.json, read by bench_cells)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "run_segalign")
TOP = 5  # device ops and idle gaps a profile lists
STAGE_TOP = 8  # device ops a profile lists for each host stage


@contextlib.contextmanager
def _env(**values):
    """The block runs with these environment variables (None unsets one)."""
    old = {k: os.environ.get(k) for k in values}

    def put(vals):
        for k, v in vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    put(values)
    try:
        yield
    finally:
        put(old)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the main path's kernels as a trace names them: each launch counter's name
# (ops/launches.py) and the symbol of the __global__ function it launches
TRACE_KERNELS = (
    ("first_scan_seq", "first_scan_seq_kernel"),        # K1s
    ("first_scan", "first_scan_kernel"),                # K1
    ("gather_rows_tile", "gather_rows_tile_kernel"),    # K3
    ("gather_rows", "gather_rows_kernel"),              # K2
    ("window_scan_seq", "window_scan_seq_kernel"),      # K4s
    ("window_scan", "carried_scan_kernel<true>"),       # K4
    ("window_scan_wide", "carried_scan_kernel<false>"),  # K5
)
_TRACE_RE = [(k, re.compile(r"(?<![\w])" + re.escape(sym) + r"(?![\w])"))
             for k, sym in TRACE_KERNELS]


def kernel_of(name: str):
    """The launch counter's name of the kernel a trace event names, or
    None for any other device op."""
    return next((k for k, rx in _TRACE_RE if rx.search(name)), None)


def _stage_of(spans):
    """A function from a host time to the stage whose span holds it (None
    outside every span; nrange, a count, holds none)."""
    by = {}
    for stage, s, e in spans:
        if stage != "nrange":
            by.setdefault(stage, []).append((s, e))
    index = {k: (sorted(v), sorted(s for s, _ in v)) for k, v in by.items()}

    def at(t):
        for stage, (v, starts) in index.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < v[i][1]:
                return stage
        return None
    return at


def summarize_profile(events, spans, start, end) -> dict:
    """What one profiled pass shows of the device. events: (start, end,
    name[, launch]) of the device's activity (kernels, copies, sets),
    launch the host time of the call that queued it where the trace links
    them; spans: (stage, start, end) of the aligner's host stages; [start,
    end] the pass; all in ns of one clock. Returns the share of the pass
    the device was busy, the device ops that took most time, the longest
    idle gaps, each named by the host stage that covered most of it ("no
    stage": the host was between stages, in the pipeline's own code;
    nrange is a count, not a time, and names none), each main-path
    kernel's device ms and launches (`kernels`, by launch counter), the
    device ms of the ops queued while each stage's span was open
    (`stage_device_ms`; `launch_linked`: the share of device ops whose
    launch the trace gave) and those ops by name (`stage_ops`: each
    stage's STAGE_TOP ops by device ms with their calls, then the rest in
    one row, so that a stage's rows sum to its stage_device_ms)."""
    events = [(ev[0], ev[1], ev[2], ev[3] if len(ev) > 3 else None)
              for ev in events]
    iv = sorted((max(s, start), min(e, end)) for s, e, _, _ in events
                if e > start and s < end)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, t = [], start
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if end > t:
        gaps.append((t, end))
    gaps.sort(key=lambda g: g[0] - g[1])
    ops = {}
    kernels = {k: dict(ms=0.0, launches=0) for k, _ in TRACE_KERNELS}
    stage_ms, stage_ops, linked = {}, {}, 0
    stage_at = _stage_of(spans)
    for s, e, name, launch in events:
        ms, n = ops.get(name, (0.0, 0))
        ops[name] = (ms + (e - s) / 1e6, n + 1)
        k = kernel_of(name)
        if k is not None:
            kernels[k]["ms"] += (e - s) / 1e6
            kernels[k]["launches"] += 1
        if launch is not None:
            linked += 1
            stage = stage_at(launch)
            if stage is not None:
                stage_ms[stage] = stage_ms.get(stage, 0.0) + (e - s) / 1e6
                by = stage_ops.setdefault(stage, {})
                ms, n = by.get(name, (0.0, 0))
                by[name] = (ms + (e - s) / 1e6, n + 1)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]
    named = []
    for g0, g1 in gaps[:TOP]:
        cover = {}
        for stage, s, e in spans:
            o = min(e, g1) - max(s, g0)
            if o > 0 and stage != "nrange":
                cover[stage] = cover.get(stage, 0) + o
        stage = max(cover, key=cover.get) if cover else "no stage"
        named.append(dict(ms=round((g1 - g0) / 1e6, 3),
                          at_ms=round((g0 - start) / 1e6, 3), stage=stage,
                          covered=round(cover.get(stage, 0) / (g1 - g0), 3)))
    window = max(end - start, 1)
    busy = sum(e - s for s, e in merged)
    return dict(pass_ms=round(window / 1e6, 3),
                busy_share=round(busy / window, 4),
                idle_ms=round((window - busy) / 1e6, 3),
                top_ops=[dict(name=k[:80], ms=round(ms, 3), calls=n)
                         for k, (ms, n) in top],
                longest_gaps=named,
                kernels={k: dict(ms=round(v["ms"], 4),
                                 launches=v["launches"])
                         for k, v in kernels.items()},
                stage_device_ms={k: round(v, 4)
                                 for k, v in sorted(stage_ms.items())},
                stage_ops={k: _top_rows(v)
                           for k, v in sorted(stage_ops.items())},
                launch_linked=(round(linked / len(events), 4) if events
                               else None))


def _top_rows(ops: dict) -> list:
    """{name: (ms, calls)} as rows by device ms: the STAGE_TOP first, then
    the others summed into one row named by their count."""
    rows = sorted(ops.items(), key=lambda kv: -kv[1][0])
    rest = rows[STAGE_TOP:]
    if rest:
        rows = rows[:STAGE_TOP] + [(
            f"({len(rest)} other ops)", (sum(ms for _, (ms, _) in rest),
                                         sum(n for _, (_, n) in rest)))]
    return [dict(name=k[:160], ms=round(ms, 4), calls=n)
            for k, (ms, n) in rows]


def is_launch(name: str) -> bool:
    """Whether a trace's host event is a call of the CUDA runtime or
    driver (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel...), the
    calls that queue device work; torch's ops are aten::*."""
    return name.startswith("cu")


def _profile(run_pass, device):
    """One more pass under torch.profiler (host and device activity), the
    aligner's stages recorded (pipeline.device.STAGE_SPANS):
    summarize_profile of it. None on the CPU, which has no device to
    trace."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile, record_function
    started = time.time()
    spans = []
    devmod.STAGE_SPANS = spans
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            on = time.time()
            t0 = time.time_ns()
            with record_function("bench_pass_start"):
                pass
            before = launch_counts()
            run_pass()
            torch.cuda.synchronize(device)
            t1 = time.time_ns()
            counted = launch_counts(before)
    finally:
        devmod.STAGE_SPANS = None
    off = time.time()
    # the trace's clock against time.time_ns(), from the pass's first
    # event; a device op's launch: the host call of the CUDA runtime or
    # driver with its correlation id (torch's own ops number theirs apart)
    offset, device_ops, launched_at = 0, [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                device_ops.append(e)
            continue
        name = e.name()
        if is_launch(name):
            launched_at[e.correlation_id()] = e.start_ns()
        elif name == "bench_pass_start":
            offset = e.start_ns() - t0
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
               launched_at.get(e.correlation_id()) if e.correlation_id()
               else None) for e in device_ops]
    out = summarize_profile(
        events, [(n, s + offset, e + offset) for n, s, e in spans],
        t0 + offset, t1 + offset)
    # the trace's launches of each kernel against its wrapper's count
    out["unlike_counter"] = {k: [v["launches"], counted[k]]
                             for k, v in out["kernels"].items()
                             if v["launches"] != counted[k]}
    # what the trace costs beside the pass: starting the profiler, stopping
    # it (the trace's collection), reading its events
    out["overhead_s"] = dict(start=round(on - started, 3),
                             stop=round(off - t1 / 1e9, 3),
                             read=round(time.time() - off, 3))
    return out


SERIAL_PASSES = 3  # the per-layer passes a cell makes: one is noisy


def _layers(run_pass) -> dict:
    """The per-layer passes: SERIAL_PASSES more passes with a synchronize
    after every device stage and no finisher thread (SEGALIGN_SYNC=1,
    SEGALIGN_OVERLAP=0); each stage's seconds (STAGE_TOTALS) and the wall
    as the median over them, the walls of each, and the first one's
    kernel launches."""
    walls, stages, launches = [], [], None
    for _ in range(SERIAL_PASSES):
        devmod.reset_stage_totals()
        before = launch_counts()
        with _env(SEGALIGN_SYNC="1", SEGALIGN_OVERLAP="0"):
            t0 = time.time()
            run_pass()
            walls.append(time.time() - t0)
        stages.append(dict(devmod.STAGE_TOTALS))
        launches = launches or launch_counts(before)
    names = sorted({k for st in stages for k in st})
    med = {k: float(np.median([st.get(k, 0.0) for st in stages]))
           for k in names}
    wall = float(np.median(walls))
    return dict(serial_wall_s=round(wall, 4),
                serial_walls_s=[round(w, 4) for w in walls],
                stages_s={k: round(v, 4) for k, v in med.items()},
                covered=round(sum(med.values()) / max(wall, 1e-9), 3),
                launches=launches)


def _fresh(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


# ---- the host and the card beside the timed window: what could explain a
# run that moves (the detail line's `passes` and `window`)

class _GcClock:
    """Python's garbage collections and their time while installed
    (gc.callbacks); `n` and `ms` only grow."""

    def __init__(self):
        self.n, self.ms, self._t0 = 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.n += 1
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    @contextlib.contextmanager
    def installed(self):
        gc.callbacks.append(self)
        try:
            yield self
        finally:
            gc.callbacks.remove(self)


def _host_sample(clock: _GcClock) -> dict:
    """This process's and its children's CPU seconds (every thread) and the
    GC clock, now."""
    me = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return dict(cpu=me.ru_utime + me.ru_stime,
                kids_cpu=kids.ru_utime + kids.ru_stime, gc_n=clock.n,
                gc_ms=clock.ms)


def _host_delta(a: dict, b: dict) -> dict:
    """What a pass took besides its wall, from two _host_sample's: CPU
    seconds of this process and of the processes it waited for, and GC
    collections and ms."""
    return dict(cpu_s=round(b["cpu"] - a["cpu"], 4),
                child_cpu_s=round(b["kids_cpu"] - a["kids_cpu"], 4),
                gc_n=b["gc_n"] - a["gc_n"],
                gc_ms=round(b["gc_ms"] - a["gc_ms"], 3))


SMI_QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"


def _card_sample(device):
    """The card's SM clock (MHz), power draw and limit (W) and temperature
    (C) from nvidia-smi; None on the CPU, or where nvidia-smi fails."""
    if device.type != "cuda":
        return None
    try:
        p = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        vals = p.stdout.strip().splitlines()[device.index or 0].split(",")
        return dict(zip(("sm_mhz", "power_w", "power_limit_w", "temp_c"),
                        (float(v) for v in vals)))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def _loadavg():
    try:
        with open("/proc/loadavg") as f:
            return [float(x) for x in f.read().split()[:3]]
    except (OSError, ValueError):
        return None


def _window_sample(device) -> dict:
    """Sampled just before and just after a process's timed passes."""
    return dict(card=_card_sample(device), loadavg=_loadavg())


def _window(before, after, first, last) -> dict:
    """The timed window of a process: the card and the load average on
    each side, the CPUs this process may run on, torch's intra-op threads,
    and the host's totals over the window (_host_delta)."""
    return dict(before=before, after=after,
                affinity=sorted(os.sched_getaffinity(0)),
                torch_threads=torch.get_num_threads(),
                host=_host_delta(first, last))


# ---- each thread's CPU seconds in a pair cell's process, read from
# /proc/self/task

CLOCK_TICK = os.sysconf("SC_CLK_TCK")


def _threads_now(skip=()) -> dict:
    """{tid: (name, user s, system s)} of this process's threads but those
    in `skip`, from /proc/self/task/*/stat."""
    out = {}
    for tid in map(int, os.listdir("/proc/self/task")):
        if tid in skip:
            continue
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                text = f.read()
        except OSError:  # the thread ended meanwhile
            continue
        end = text.rindex(")")
        fields = text[end + 2:].split()  # from field 3, the state
        out[tid] = (text[text.index("(") + 1:end],
                    int(fields[11]) / CLOCK_TICK,
                    int(fields[12]) / CLOCK_TICK)
    return out


class _ThreadClock:
    """Each thread's CPU seconds over a window, from /proc/self/task: every
    thread when the window starts and when it ends, and the threads born
    since its start at each peek(), which a pass calls as it delivers its
    last chunk-strand (map_chunks' on_result): then the pass's finisher
    thread has done the pass's work and not yet ended."""

    def __init__(self):
        self.first, self.last = {}, {}

    def start(self):
        self.first = _threads_now()
        self.last.update(self.first)

    def peek(self):
        self.last.update(_threads_now(skip=self.first))

    def stop(self):
        self.last.update(_threads_now())

    def report(self) -> list:
        """Each thread seen: its name, role (main, from the window's start,
        or born inside it), and user and system CPU seconds inside the
        window (to its last reading)."""
        out = []
        for tid, (name, user, system) in sorted(self.last.items()):
            _, user0, system0 = self.first.get(tid, (None, 0.0, 0.0))
            role = ("main" if tid == os.getpid() else
                    "from the start" if tid in self.first else
                    "born in the window")
            out.append(dict(tid=tid, name=name, role=role,
                            user_s=round(user - user0, 3),
                            sys_s=round(system - system0, 3)))
        return out


def _pair_process(c, device, pair: str, layers: bool) -> dict:
    """One process of a pair cell (bench --worker) on the pair its parent
    drew (`pair`, an .npz of ref and query): a cold pass on a fresh
    aligner (its wall from the aligner's making, with the table build and
    the uploads, is the cold start), then c.passes steady passes on its
    resident table, timed; with `layers`, then the per-layer passes and
    the profiled pass; last, each pass's HSPs rescored from the sequences
    (bench_cells.rescore_failures), outside every timed or traced window.
    Returns what the process prints for its parent, as JSON, with the
    seconds of each of these phases."""
    t0 = time.time()
    with np.load(pair) as f:
        ref, query = f["ref"], f["query"]
    qrc = revcomp_codes(query)
    work = bench_inputs.chunk_work(query)
    settings = bench_inputs.aligner_settings(device)
    clock = _GcClock()
    phases = dict(inputs=time.time() - t0)

    def one(al, threads=None):
        def on_result(i, _):
            if i == len(work) - 1:
                threads.peek()
        s0 = _host_sample(clock)
        before = launch_counts()
        t0 = time.time()
        results = al.map_chunks(
            work, depth=DEPTH, on_result=None if threads is None
            else on_result)
        _sync(device)
        dt = time.time() - t0
        host = _host_delta(s0, _host_sample(clock))
        named = bench_cells.named_hsps(results, work)
        return dict(dt=dt, host=host, counts=dict(
            seeds=sum(r.num_seeds for r in results),
            hits=sum(r.num_hits for r in results),
            hsps=sum(len(r.hsps) for r in results),
            digest=bench_cells.hsp_digest(named)),
            named=named, launches=launch_counts(before))

    with clock.installed():
        t0 = time.time()
        al = make_aligner(device, device_seeding=c.device_seeding)
        al.set_ref(ref)
        al.set_query(query, qrc)
        cold = one(al)
        phases["cold_start"] = time.time() - t0
        w0, h0 = _window_sample(device), _host_sample(clock)
        threads = _ThreadClock()
        t0 = time.time()
        threads.start()
        runs = [one(al, threads) for _ in range(c.passes)]
        threads.stop()
        phases["timed"] = time.time() - t0
        h1, w1 = _host_sample(clock), _window_sample(device)
    out = dict(mbp=len(query) / 1e6, cold_start=phases["cold_start"],
               peak=_peak(device), peak_allocated=_peak_allocated(device),
               window=_window(w0, w1, h0, h1),
               threads=threads.report())
    if layers:
        t0 = time.time()
        out.update(layers=_layers(lambda: one(al)),
                   profile=_profile(lambda: one(al), device))
        phases["layers"] = time.time() - t0
    t0 = time.time()
    for p in (cold, *runs):
        p["rescore"] = bench_cells.rescore_failures(
            ref, query, qrc, p.pop("named"), settings["sub_mat"],
            settings["hspthresh"])
    phases["rescore"] = time.time() - t0
    return dict(out, cold=cold, runs=runs, phases_s=phases,
                jax_modules=sorted(jax_modules()))


WORKER_TIMEOUT = 900  # s a pair cell's process may take


class WorkerError(RuntimeError):
    """A pair cell's process exited non-zero, ran past WORKER_TIMEOUT or
    printed no result line: the cell fails, and no pass runs in its
    stead."""


def _worker_argv(c, device, pair: str, layers: bool) -> list:
    """The command of one process of pair cell c: this module with
    --worker, the benchmark file this process read (a child does not see a
    caller's change to bench_cells.BENCHMARK) and the pair's file."""
    return [sys.executable, "-m", "segalign_tpu_torch.bench", "--worker",
            "--benchmark", bench_cells.BENCHMARK, "--cell", c.name,
            "--pair", pair, "--device", str(device),
            *(["--layers"] if layers else [])]


def _run_worker(argv: list) -> dict:
    """Run one process of a pair cell from the checkout's root and return
    its result line, with its wall and its start-up (from its launch to
    worker_main); its stderr is passed on. WorkerError when it fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    t0 = time.time()
    try:
        p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=WORKER_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        raise WorkerError(f"{shlex.join(argv)} ran past {WORKER_TIMEOUT} "
                          f"s") from e
    wall = time.time() - t0
    sys.stderr.write(p.stderr)
    lines = p.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1])["worker"]
    except (IndexError, ValueError, KeyError, TypeError):
        out = None
    if p.returncode != 0 or not isinstance(out, dict):
        raise WorkerError(f"{shlex.join(argv)} exited {p.returncode} "
                          f"{'with' if isinstance(out, dict) else 'and no'} "
                          f"result line:\n{p.stderr[-3000:]}")
    out["phases_s"] = dict(start=out.pop("began") - t0, **out["phases_s"])
    return dict(out, wall_s=wall)


def _pair_cell(c, seed, device, work_dir):
    """The aligner's passes over both strands of every chunk of a pair
    drawn here once (into work_dir), in c.processes fresh processes one
    after another (_pair_process: a cold pass, then c.passes timed steady
    passes, each); the last one then runs the per-layer passes and the
    profiled pass, once every timed pass has ended. No pass runs in this
    process."""
    pair = os.path.join(work_dir, "pair.npz")
    ref, query = bench_cells.make_pair(c.inputs, c.ref_mbp, c.query_mbp,
                                       seed)
    np.savez(pair, ref=ref, query=query)
    procs = []
    for i in range(c.processes):
        procs.append(_run_worker(_worker_argv(
            c, device, pair, layers=i == c.processes - 1)))
        print(f"cell {c.name}: process {i + 1} of {c.processes} in "
              f"{procs[-1]['wall_s']:.1f} s, passes "
              f"{[round(p['dt'], 4) for p in procs[-1]['runs']]}",
              file=sys.stderr, flush=True)
    peaks = [w["peak"] for w in procs if w["peak"] is not None]
    return dict(mbp=procs[0]["mbp"], processes=procs,
                runs=[p for w in procs for p in w["runs"]],
                checked=[(f"process {i} {kind}", p)
                         for i, w in enumerate(procs)
                         for kind, p in [("cold pass", w["cold"])] + [
                             (f"pass {j}", q)
                             for j, q in enumerate(w["runs"])]],
                peak=max(peaks) if peaks else None,
                layers=procs[-1]["layers"], profile=procs[-1]["profile"])


def _cli_cell(c, seed, device, work_dir):
    """The pairwise CLI through its launcher (scripts/run_segalign) on the
    layout's FASTA pair, --nogapped --markend on one card: a pass is one
    process, its wall from start to exit; `rescore` checks its segments
    against the sequences. The per-layer and profiled passes call the CLI's
    main in this process."""
    from .cli.run_segalign import main as cli_main
    ref_fa = os.path.join(work_dir, "ref.fa")
    query_fa = os.path.join(work_dir, "query.fa")
    t0 = time.time()
    ref, query = bench_cells.write_scale_pair(
        c.inputs, ref_fa, query_fa, c.ref_mbp, c.query_mbp, seed)
    print(f"cell {c.name}: {c.inputs} written in {time.time() - t0:.1f} s",
          file=sys.stderr, flush=True)
    _, _, ref_rec, query_rec = bench_inputs.SCALE_INPUTS[c.inputs]
    records = (bench_inputs.record_layout(*ref_rec, len(ref)),
               bench_inputs.record_layout(*query_rec, len(query)))
    qrc = revcomp_codes(query)
    settings = bench_inputs.aligner_settings(device)
    argv = [ref_fa, query_fa, "--nogapped", "--markend", "--device",
            str(device), "--num_devices", "1", *c.cli_args]
    route = {"SEGALIGN_DEVICE_SEEDING": "1" if c.device_seeding else None}

    def one(i):
        cwd = _fresh(os.path.join(work_dir, f"run_{i}"))
        out = os.path.join(cwd, "out.segments")
        env = {k: v for k, v in os.environ.items()
               if k != "SEGALIGN_DEVICE_SEEDING"}
        env.update({k: v for k, v in route.items() if v},
                   SEGALIGN_LOG_JSON="1", PYTHONPATH=os.pathsep.join(
                       filter(None, [ROOT, env.get("PYTHONPATH")])))
        s0 = _host_sample(clock)
        t0 = time.time()
        p = subprocess.run([LAUNCHER, *argv, "--output", out], cwd=cwd,
                           env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
        dt = time.time() - t0
        host = _host_delta(s0, _host_sample(clock))
        stats = [json.loads(ln) for ln in p.stderr.splitlines()
                 if ln.startswith("{") and '"event":"stats"' in ln]
        if p.returncode != 0 or len(stats) != 1:
            raise RuntimeError(f"{LAUNCHER} exited {p.returncode} with "
                               f"{len(stats)} stats events:\n"
                               f"{p.stderr[-3000:]}")
        st = stats[0]
        with open(out, "rb") as f:
            data = f.read()
        return dict(dt=dt, host=host, counts=dict(
            seeds=st["seeds"], hits=st["seed_hits"], hsps=st["hsps"],
            segments=data.count(b"\n") - 1,
            sha256=hashlib.sha256(data).hexdigest()),
            data=data, launches=st["launches"], stage_s=st["seconds"],
            peak=max(st["peak_reserved_bytes"], default=None),
            peak_allocated=max(st["peak_device_bytes"], default=None))

    def in_process():
        cwd = _fresh(os.path.join(work_dir, "in_process"))
        with contextlib.chdir(cwd), _env(**route):
            rc = cli_main([*argv, "--output", os.path.join(cwd, "out")])
        if rc != 0:
            raise RuntimeError(f"run_segalign's main returned {rc}")

    clock = _GcClock()
    with clock.installed():
        w0, h0 = _window_sample(device), _host_sample(clock)
        runs = [one(i) for i in range(c.passes)]
        h1, w1 = _host_sample(clock), _window_sample(device)
    peaks = [r["peak"] for r in runs if r["peak"] is not None]
    out = dict(mbp=len(query) / 1e6, runs=runs,
               checked=[(f"pass {i}", p) for i, p in enumerate(runs)],
               peak=max(peaks) if peaks else None,
               window=_window(w0, w1, h0, h1),
               layers=dict(_layers(in_process), stats_seconds=[
                   r["stage_s"] for r in runs]),
               profile=_profile(in_process, device))
    for p in runs:
        p["rescore"] = bench_cells.rescore_failures(
            ref, query, qrc, bench_cells.segments_hsps(
                p.pop("data"), *records, len(query)),
            settings["sub_mat"], settings["hspthresh"], unique=False)
    return out


def _peak(device):
    """peak_device_gib's bytes in this process: max_memory_reserved, what
    it held on the card, the CUDA graphs' private pools included (None
    without a card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_reserved(device)


def _peak_allocated(device):
    """max_memory_allocated, kept beside _peak in the detail line: it does
    not see a graph's working memory once the graph is captured."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)


def total_rate(mbp: float, seconds: list) -> float:
    """query_mbp_per_s: the Mbp of every timed pass (mbp each) over their
    seconds in all, so a slow pass counts for its whole wall."""
    return mbp * len(seconds) / sum(seconds)


# the per-layer metrics each route reports (BENCHMARK.json's layer_metrics
# declares each, with the admitted cells that report it): the serial
# passes' stages, and the kernels by launch counter
LAYER_STAGES = dict(native=("seeds", "plan", "extend", "pack", "host_dedup"),
                    device=("seeds", "extend", "host_dedup"))
LAYER_KERNELS = dict(native=(("k1s", "first_scan_seq"),
                             ("k4s", "window_scan_seq")),
                     device=(("k1s", "first_scan_seq"),
                             ("k4s", "window_scan_seq")))


def layer_values(c, r) -> dict:
    """Every per-layer metric of cell c from its run r, by name: the
    serial passes' stage seconds (medians), the profiled pass's device ms
    and launches by kernel, device ms by the host stage that queued it and
    busy share (None without a card, or where the trace linked no launch),
    and a CLI cell's process wall outside the ungapped stage (median)."""
    route = "device" if c.device_seeding else "native"
    stages, prof = r["layers"]["stages_s"], r["profile"]
    out = {f"{k}_s": stages.get(k, 0.0) for k in LAYER_STAGES[route]}
    for short, counter in LAYER_KERNELS[route]:
        k = prof["kernels"][counter] if prof else {}
        out[f"{short}_device_ms"] = k.get("ms")
        out[f"{short}_launches"] = k.get("launches")
    linked = bool(prof and prof["launch_linked"])
    for stage in ("seeds", "extend"):
        out[f"{stage}_device_ms"] = (prof["stage_device_ms"].get(stage, 0.0)
                                     if linked else None)
    out["device_busy_share"] = prof["busy_share"] if prof else None
    if c.kind == "cli":
        out["outside_ungapped_s"] = float(np.median(
            [p["dt"] - p["stage_s"] for p in r["runs"]]))
    return out


def run_cell(name: str, seed: int, device) -> dict:
    """Run one cell of BENCHMARK.json; returns its result line (cell,
    seed, correct, the metrics, their units) and its detail (every pass,
    each process of a pair cell, the per-layer pass, the profile, the
    gate's findings). The gate: every pass of every process gives the same
    output, every HSP of it rescores from the sequences, at seed 2024 it
    equals the cell's constants (the JAX package's), and no process of a
    pair cell loaded the JAX side of the repo. query_mbp_per_s is
    total_rate of every timed pass."""
    c = bench_cells.cell(name)
    units = bench_cells.metric_units()
    work_dir = _fresh(os.path.join(ROOT, "build", "bench", c.name))
    run = dict(pair=_pair_cell, cli=_cli_cell)[c.kind]
    try:
        r = run(c, seed, device, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    procs = r.get("processes", [])
    first = r["runs"][0]["counts"]
    failures = [f"{label}: {p['counts']}; the first timed pass: {first}"
                for label, p in r["checked"] if p["counts"] != first]
    failures += [f"{label}: {m}" for label, p in r["checked"]
                 for m in p["rescore"]]
    failures += [f"process {i}: the JAX side of the repo was loaded: "
                 f"{w['jax_modules'][:8]}" for i, w in enumerate(procs)
                 if w["jax_modules"]]
    golden = seed == bench_cells.DEFAULT_SEED
    if golden:
        failures += bench_cells.check(c.gate, first)
    dts = [p["dt"] for p in r["runs"]]
    rates = [r["mbp"] / dt for dt in dts]
    q = [float(np.percentile(rates, k)) for k in (25, 50, 75)]
    metrics = dict(
        query_mbp_per_s=total_rate(r["mbp"], dts),
        peak_device_gib=None if r["peak"] is None else r["peak"] / 2**30)
    where = f" in {len(procs)} processes" if len(procs) > 1 else ""
    notes = dict(
        query_mbp_per_s=f"{len(rates)} passes' Mbp over their seconds"
                        f"{where}; a pass's median {q[1]:.4f}, quartiles "
                        f"{q[0]:.4f} / {q[2]:.4f}, slowest pass "
                        f"{max(dts):.4f} s ({min(rates):.4f})",
        peak_device_gib=("torch.cuda.max_memory_reserved, the largest "
                         "process's" if device.type == "cuda"
                         else "no card"))
    for k, v in metrics.items():
        shown = "not measured" if v is None else f"{v:.4f} {units[k]}"
        print(f"metric {k}: {shown} ({notes[k]})", flush=True)
    declared = bench_cells.layer_metrics()
    layers = {k: None if v is None else round(v, 4)
              for k, v in layer_values(c, r).items()}
    for k, v in layers.items():
        shown = ("not measured" if v is None
                 else f"{v:.4f} {declared[k]['unit']}")
        print(f"layer {k}: {shown} (layer {declared[k]['layer']}, moves "
              f"{declared[k]['moves']})", flush=True)
    prof = r["profile"]
    breakdown = None if prof is None else dict(
        busy_share=prof["busy_share"], top_ops=prof["top_ops"],
        longest_gaps=prof["longest_gaps"])
    if breakdown:
        for op in breakdown["top_ops"]:
            print(f"breakdown op: {op['ms']:.3f} ms in {op['calls']} calls "
                  f"{op['name']}", flush=True)
        for g in breakdown["longest_gaps"]:
            print(f"breakdown idle: {g['ms']:.3f} ms at {g['at_ms']:.3f} ms "
                  f"in {g['stage']} ({g['covered']:.0%} covered)",
                  flush=True)
        for stage, rows in prof["stage_ops"].items():
            for op in rows:
                print(f"breakdown stage op: {stage}: {op['ms']:.3f} ms in "
                      f"{op['calls']} calls {op['name']}", flush=True)
    for f in failures:
        print(f"gate: {c.name}: {f}", file=sys.stderr, flush=True)
    detail = dict(
        cell=c.name, config=c.config, seed=seed, inputs=c.inputs,
        ref_mbp=c.ref_mbp, query_mbp=c.query_mbp,
        gate="golden and rescored" if golden else "rescored",
        counts=first, failures=failures,
        pass_s=[round(p["dt"], 4) for p in r["runs"]],
        passes=[p["host"] for p in r["runs"]], window=r.get("window"),
        # each process's peaks: a pair cell's workers, a CLI cell's runs
        peaks=[dict(reserved_bytes=w["peak"],
                    allocated_bytes=w["peak_allocated"])
               for w in procs or r["runs"]],
        pass_mbp_per_s_quartiles=[round(x, 4) for x in q],
        slowest_pass_s=round(max(dts), 4),
        # a pair cell's: the median over its processes
        cold_pass_s=(round(float(np.median([w["cold"]["dt"]
                                            for w in procs])), 4)
                     if procs else None),
        cold_start_s=(round(float(np.median([w["cold_start"]
                                             for w in procs])), 4)
                      if procs else None),
        launches=r["runs"][0]["launches"], layers=r["layers"],
        profile=r["profile"],
        processes=[dict(pass_s=[round(p["dt"], 4) for p in w["runs"]],
                        passes=[p["host"] for p in w["runs"]],
                        cold_pass_s=round(w["cold"]["dt"], 4),
                        cold_start_s=round(w["cold_start"], 4),
                        peak_reserved_bytes=w["peak"],
                        peak_allocated_bytes=w["peak_allocated"],
                        window=w["window"],
                        threads=w["threads"],
                        wall_s=round(w["wall_s"], 3),
                        phases_s={k: round(v, 3)
                                  for k, v in w["phases_s"].items()},
                        jax_modules=w["jax_modules"]) for w in procs])
    line = dict(cell=c.name, seed=seed, correct=not failures,
                **{k: (None if v is None else round(v, 4))
                   for k, v in metrics.items()}, units=units,
                layers=layers,
                layer_units={k: declared[k]["unit"] for k in layers},
                breakdown=breakdown)
    return dict(line=line, detail=detail)


# the JAX side of the repo: the benchmark measures the port alone, and a
# result is refused once any of them has been loaded into the run
JAX_MODULES = ("jax", "jaxlib", "flax", "segalign_tpu")


def jax_modules() -> set:
    """The modules of JAX_MODULES (and their submodules) in sys.modules."""
    return {m for m in sys.modules if m.split(".")[0] in JAX_MODULES}


def cell_main(args, device, preloaded=frozenset()) -> int:
    """--cell: build, run the cell, print its metrics, its detail, the
    card and its result line; non-zero when the gate fails, or when a
    module of JAX_MODULES other than the preloaded (the caller's own) was
    loaded by the end of the run (the result line then says correct
    false), and with no result line when a pair cell's process failed
    (WorkerError)."""
    bench_cells.cell(args.cell)  # an unknown cell fails before the build
    _build_all(device)
    try:
        out = run_cell(args.cell, args.seed, device)
    except WorkerError as e:
        print(f"gate: {args.cell}: {e}", file=sys.stderr, flush=True)
        return 1
    loaded = sorted(jax_modules() - set(preloaded))
    if loaded:
        print(f"gate: {args.cell}: the JAX side of the repo was loaded into "
              f"the run: {loaded[:8]}", file=sys.stderr, flush=True)
        out["detail"]["failures"].append(f"loaded {loaded[:8]}")
        out["line"]["correct"] = False
    print(json.dumps(out["detail"]), flush=True)
    if device.type == "cuda":
        from .scripts import print_card
        print_card("bench")
        platform, kind = "gpu", torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
    else:
        platform, kind, count = "cpu", "cpu", 0
    print(json.dumps(dict(out["line"], device=dict(
        platform=platform, kind=kind, count=count))), flush=True)
    return 0 if out["line"]["correct"] else 1


def _build_all(device):
    """Build (or load) the CUDA kernels and the native host library before
    any timed window; print their build times."""
    if device.type == "cuda":
        print(f"bench device: {torch.cuda.get_device_name(device)}, torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}",
              file=sys.stderr, flush=True)
        t0 = time.time()
        _build.kernels()
        t_k = time.time() - t0
    t0 = time.time()
    _build.native_lib_path()
    t_n = time.time() - t0
    print("build: " + (f"CUDA kernels {t_k:.2f} s, " if device.type == "cuda"
                       else "") + f"native host library {t_n:.2f} s "
          "(not in cold_s)", file=sys.stderr, flush=True)


def worker_main(args, device) -> int:
    """--worker: one process of a pair cell (_pair_process), its result as
    one JSON line {"worker": ...}; its parent (run_cell) builds the kernels
    and the native library first, so here they load. Its result carries
    the time it began, and the seconds its load took besides
    _pair_process's phases."""
    began = time.time()
    c = bench_cells.cell(args.cell)
    if c.kind != "pair":
        raise SystemExit(f"bench: --worker runs a pair cell; {c.name} is a "
                         f"{c.kind} cell")
    _build_all(device)
    build = time.time() - began
    out = _pair_process(c, device, args.pair, args.layers)
    out["phases_s"] = dict(build=build, **out["phases_s"])
    print(json.dumps(dict(worker=dict(out, began=began))), flush=True)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m segalign_tpu_torch.bench",
        description="ungapped throughput of the port on one device; the "
                    "last stdout line is the result. With --cell, one "
                    "cell of the benchmark (BENCHMARK.json): its metrics, "
                    "its detail and its result line; exits 1 when its "
                    "output fails the gate")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions, for tests)")
    p.add_argument("--cell", help="run this cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, default=bench_cells.DEFAULT_SEED,
                   help="the cell's input seed (default 2024, the one its "
                        "gate constants were taken at)")
    p.add_argument("--benchmark", help="the benchmark file to read "
                                       "(default BENCHMARK.json at the "
                                       "checkout's root)")
    p.add_argument("--worker", action="store_true",
                   help="with --cell and --pair: one process of a pair "
                        "cell, as the cell starts each; prints its passes "
                        "as one JSON line")
    p.add_argument("--pair", help="with --worker: the .npz of the pair's "
                                  "ref and query, drawn by the cell")
    p.add_argument("--layers", action="store_true",
                   help="with --worker: then the per-layer passes and the "
                        "profiled pass")
    args = p.parse_args(argv)
    if args.benchmark:
        bench_cells.BENCHMARK = args.benchmark
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: --device cuda, and "
                         "torch.cuda.is_available() is false")
    if args.worker:
        return worker_main(args, device)
    if args.cell:
        # from the command line the process is the run's alone; called from
        # Python (the tests), what the caller had loaded is the caller's
        return cell_main(args, device,
                         frozenset() if argv is None else jax_modules())
    _build_all(device)

    ref_mbp = float(os.environ.get("BENCH_REF_MBP", 4.0))
    query_mbp = float(os.environ.get("BENCH_QUERY_MBP", 4.0))
    ref, query = load_inputs(ref_mbp, query_mbp)
    real_inputs = bool(os.environ.get("BENCH_REF_FASTA"))

    # the cold pass is the first on a fresh aligner; the steady passes are
    # the headline (best of BENCH_STEADY_REPS), BENCH_STEADY=0 keeps the
    # cold pass as headline
    res = run_config(ref, query, "repeat-1x-cold", device)
    cold_s = res["dt"]
    if os.environ.get("BENCH_STEADY", "1") != "0":
        res = _steady(ref, query, "repeat-1x", res,
                      int(os.environ.get("BENCH_STEADY_REPS", "3")))
    headline = res["mbps"]
    densities = {"1x": dict(mbps=round(res["mbps"], 3),
                            hits_per_mbp=round(res["density"]))}

    breakdown = None
    if os.environ.get("BENCH_BREAKDOWN", "1") != "0":
        breakdown = run_breakdown(ref, query, res)

    e2e_mbps = None
    if os.environ.get("SEGALIGN_BENCH_GAPPED", "1") != "0":
        sub8x8 = build_substitution_matrix(910)
        bench_gapped(ref, query, res["qrc"], res["batches"], sub8x8,
                     res["dt"])
        e2e_mbps = round(bench_gapped_overlap(
            ref, query, res["qrc"], res["al"], sub8x8), 3)

    if not real_inputs and os.environ.get("BENCH_SWEEP", "1") != "0":
        for key in ("0.5x", "4x"):
            # mult applied to BOTH genomes, a rng per mult; steady like the
            # headline (one pass after the cold one)
            r2, q2 = bench_inputs.make_inputs(f"repeat-{key}", ref_mbp,
                                              query_mbp)
            rr = run_config(r2, q2, f"repeat-{key}-cold", device)
            rr = run_config(r2, q2, f"repeat-{key}", device, al=rr["al"],
                            qrc=rr["qrc"], skip_setup=True)
            densities[key] = dict(mbps=round(rr["mbps"], 3),
                                  hits_per_mbp=round(rr["density"]))
            del r2, q2, rr

    legacy = None
    if not real_inputs and os.environ.get("BENCH_LEGACY", "1") != "0":
        r3, q3 = bench_inputs.make_inputs("legacy-planted", ref_mbp,
                                          query_mbp)
        r0 = run_config(r3, q3, "legacy-planted-cold", device)
        legacy = round(run_config(r3, q3, "legacy-planted", device,
                                  al=r0["al"], qrc=r0["qrc"],
                                  skip_setup=True)["mbps"], 3)
        del r3, q3, r0

    parity = engine_parity(ref, query, res["qrc"], device)

    out = {
        "metric": "ungapped_query_mbps",
        "value": round(headline, 3),
        "unit": "Mbp/s",
        "vs_baseline": round(headline / NOMINAL_V100_MBPS, 3),
        "cold_s": round(cold_s, 2),
        "densities": densities,
        "engine_parity": parity,
    }
    if breakdown is not None:
        out["kernel_fraction"] = breakdown["kernel_fraction"]
        out["breakdown"] = breakdown
    if e2e_mbps is not None:
        out["e2e_overlapped_mbps"] = e2e_mbps
    if legacy is not None:
        out["legacy_planted_mbps"] = legacy
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
