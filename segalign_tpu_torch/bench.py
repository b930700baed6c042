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

There is no fallback: with --device cuda and no card the bench exits
non-zero, and a kernel that fails to build or launch fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import _build, bench_inputs
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
        np.savez(dump, **{f"h{i}_{int(w.rev)}_{w.chunk_start}": r.hsps
                          for i, (r, w) in enumerate(zip(results, work))
                          if len(r.hsps)})
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
    old = {k: os.environ.get(k) for k in
           ("SEGALIGN_SYNC", "SEGALIGN_OVERLAP")}
    os.environ["SEGALIGN_SYNC"] = "1"
    os.environ["SEGALIGN_OVERLAP"] = "0"
    devmod.reset_stage_totals()
    try:
        r = run_config(ref, query, "repeat-1x-serial", res["al"].device,
                       al=res["al"], qrc=res["qrc"], skip_setup=True)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
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


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m segalign_tpu_torch.bench",
        description="ungapped throughput of the port on one device; the "
                    "last stdout line is the result")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions, for tests)")
    device = torch.device(p.parse_args(argv).device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: --device cuda, and "
                             "torch.cuda.is_available() is false")
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
    main()
