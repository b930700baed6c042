"""Run the whole benchmark several times and set its bounds from the runs:
every workload of BENCHMARK.json, in its order, by its own command, in a
process of its own.

    python -m segalign_tpu_torch.scripts.bench_runs [--runs 3]
        [--cells NAME,...] [--out DIR] [--summarize RUNS_JSONL ...]
        [-- ARG ...]

`--cells` may name the file's left_out cells too, in the order given.
Arguments after `--` are added to every cell's command (such as
`-- --seed 7`). Each cell's
output goes to DIR (default build/bench_runs) as run{R}_{cell}.out and
.err, and every cell's result line, detail line, exit code and wall to
DIR/runs.jsonl. A cell that fails is recorded and the runs go on; the
script exits 1 if any failed.

At the end it prints, for each cell and metric, the value of every run,
their spread (max - min over the median) and the move of every three
runs in a row, and for each metric the bound within the call: the
smallest of 5, 10 or 15% that covers the largest three-run move of the
cells within every metric's limit (15%, the peak's 5%), every three
runs in a row counted, with the cells past the limit named; and each
run's wall in all and each cell's. For each run of any cell it prints each
process's peak device memory, reserved (the metric's) and allocated
(peaks). For each run of a pair cell (whose detail lists its processes)
it prints each process's level (the median of its timed passes' seconds)
and what it spent (where), and, for a cell of more than one process, the
spread between the processes' levels against the median spread inside
them. For each cell it prints how much of its runs' spread no number of
processes or passes in a run can average away (shared), and each of its
per-layer metrics over its runs (layer_ranges).
Then it applies the file's admission rule over the calls (admission):
for each cell each call's largest three-run move of each metric against
its limit, and whether it is admitted (two calls of ten runs of it, every
run of each call correct, every move within its limit); last, as one
JSON line, the admitted cells and each metric's bound over their moves.
`--summarize` runs nothing and does the same for the runs that earlier
calls recorded, one runs.jsonl a call (one cut at its time limit, say).
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time
from statistics import median, stdev

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BOUNDS = (0.05, 0.10, 0.15)
LIMITS = dict(peak_device_gib=0.05)  # limit(): 15% for any other metric
RULE_CALLS, RULE_RUNS = 2, 10  # the calls a cell is admitted on, runs each


def run_cell(command: list, out_base: str) -> dict:
    """One cell's command from the checkout's root: its exit code, wall,
    result line and detail line (None where it printed none)."""
    t0 = time.time()
    with open(out_base + ".out", "w") as out, \
            open(out_base + ".err", "w") as err:
        rc = subprocess.run(command, cwd=ROOT, stdout=out,
                            stderr=err).returncode
    wall = time.time() - t0
    with open(out_base + ".out") as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    line = detail = None
    try:
        line = json.loads(lines[-1])
        detail = json.loads(lines[-2])
    except (IndexError, ValueError):
        pass
    return dict(rc=rc, wall_s=round(wall, 2), line=line, detail=detail)


def limit(metric: str) -> float:
    """The most a metric of an admitted cell may move over three runs in a
    row: 5% for the peak, 15% for the rest."""
    return LIMITS.get(metric, BOUNDS[-1])


def bound_of(moves) -> dict:
    """The smallest of BOUNDS that covers every move (None where one moves
    past 15%, or where moves is None: no cell counts) and the largest."""
    if moves is None:
        return dict(bound=None, largest_move=None)
    worst = max(moves, default=0.0)
    return dict(bound=next((b for b in BOUNDS if worst <= b), None),
                largest_move=round(worst, 4))


def summarize(results: list, metrics: dict) -> dict:
    """One call's runs: {cell: {metric: (values by run, move)}}, move the
    largest spread of three runs in a row (of all of them where fewer),
    and, by metric, the cells over its limit and the bound over the cells
    within every metric's limit (bound_of)."""
    table = {}
    for r in results:
        line = r["line"] or {}
        for m in metrics:
            if line.get(m) is not None:
                table.setdefault(r["cell"], {}).setdefault(m, []).append(
                    line[m])
    out = {}
    for cell, ms in table.items():
        for m, vals in ms.items():
            out.setdefault(cell, {})[m] = (vals, max(threes(vals)))
    over = {m: [c for c, v in out.items() if m in v and v[m][1] > limit(m)]
            for m in metrics}
    within = [c for c in out if not any(c in o for o in over.values())]
    bounds = {m: dict(bound_of([out[c][m][1] for c in within
                                if m in out[c]] if within else None),
                      over=over[m]) for m in metrics}
    return dict(cells=out, bounds=bounds)


def correct(r: dict) -> bool:
    """Whether a recorded run exited 0 with a correct result line."""
    return r["rc"] == 0 and bool((r["line"] or {}).get("correct"))


def admission(calls: list, metrics: dict) -> dict:
    """The file's rule over calls, each the runs of one call as its
    runs.jsonl records them: a cell is admitted when there are RULE_CALLS
    calls, each with RULE_RUNS runs of it, every run of the call correct,
    and every metric of it within its limit over every three runs in a
    row. {cells: {cell: dict(moves=[{metric: move} by call], why=[what
    keeps it out])}, admitted, bounds: {metric: bound_of the admitted
    cells' moves in every call}}."""
    sums = [summarize(c, metrics) for c in calls]
    cells = {}
    for cell in dict.fromkeys(r["cell"] for c in calls for r in c):
        moves, why = [], []
        if len(calls) < RULE_CALLS:
            why.append(f"{len(calls)} call(s) of the {RULE_CALLS} the rule "
                       f"asks")
        for i, (c, s) in enumerate(zip(calls, sums), 1):
            bad = [(r["run"], r["cell"]) for r in c if not correct(r)]
            if bad:
                why.append(f"call {i}: runs not correct, so the call admits "
                           f"nothing: {bad}")
            n = sum(r["cell"] == cell for r in c)
            if n < RULE_RUNS:
                why.append(f"call {i}: {n} runs of the {RULE_RUNS}")
            got = {m: v[1] for m, v in s["cells"].get(cell, {}).items()}
            moves.append(got)
            for m in metrics:
                if m not in got:
                    why.append(f"call {i}: {m} not measured")
                elif got[m] > limit(m):
                    why.append(f"call {i}: {m} moved {100 * got[m]:.2f}% "
                               f"over three runs in a row, past "
                               f"{100 * limit(m):.0f}%")
        cells[cell] = dict(moves=moves, why=why)
    admitted = [c for c, v in cells.items() if not v["why"]]
    bounds = {m: bound_of([mv[m] for c in admitted
                           for mv in cells[c]["moves"]] if admitted
                          else None) for m in metrics}
    return dict(cells=cells, admitted=admitted, bounds=bounds)


def spread(vals: list) -> float:
    """max - min over the median (0 where the median is 0)."""
    med = median(vals)
    return (max(vals) - min(vals)) / med if med else 0.0


def threes(vals: list) -> list:
    """The spread of every three runs in a row (of all of them where
    fewer)."""
    return [spread(vals[i:i + 3]) for i in range(max(len(vals) - 2, 1))]


def levels(detail) -> list:
    """Each process's level in a run of a pair cell: the median of its
    timed passes' seconds ([] for a run that lists no processes)."""
    return [median(p["pass_s"]) for p in (detail or {}).get("processes")
            or []]


def process_spreads(detail):
    """(spread between the processes' levels, median spread of the passes
    inside each process) of a run of a pair cell."""
    procs = detail["processes"]
    return (spread(levels(detail)),
            median(spread(p["pass_s"]) for p in procs))


def shared(results: list, cell: str):
    """(sd of the runs' means, the sd they would have if every unit of a
    run were drawn alone, the sd of what the units of a run share), each
    over the mean of the runs' means, of `cell`'s seconds: its units are
    its processes' levels where it has more than one process, else its
    timed passes. None with fewer than 3 runs."""
    groups = [levels(r["detail"]) if len(levels(r["detail"])) > 1
              else r["detail"]["pass_s"] for r in results
              if r["cell"] == cell and r["detail"]]
    if len(groups) < 3:
        return None
    means = [sum(g) / len(g) for g in groups]
    mu = sum(means) / len(means)
    sd = stdev(means)
    alone = sum(stdev(g) / len(g) ** .5 for g in groups) / len(groups)
    return (sd / mu, alone / mu, max(sd * sd - alone * alone, 0) ** .5 / mu)


def layer_ranges(results: list, cell: str) -> dict:
    """{per-layer metric: (min, median, max) over the runs of `cell`}
    from the result lines' `layers` (a metric null in every run, as
    without a card, is left out)."""
    vals = {}
    for r in results:
        if r["cell"] == cell:
            for k, v in ((r["line"] or {}).get("layers") or {}).items():
                if v is not None:
                    vals.setdefault(k, []).append(v)
    return {k: (min(v), median(v), max(v)) for k, v in vals.items()}


def peaks(detail) -> str:
    """Each process's peak device memory in a run, reserved / allocated
    GiB, from its detail ('' for a run whose detail lists no peaks)."""
    def gib(b):
        return "none" if b is None else f"{b / 2**30:.4f}"
    return ", ".join(f"{gib(p['reserved_bytes'])} / "
                     f"{gib(p['allocated_bytes'])}"
                     for p in (detail or {}).get("peaks") or [])


def where(proc: dict) -> str:
    """What one process of a pair cell spent, from its detail: its wall
    and each phase's seconds (start-up to its main, the kernels' and the
    library's load, the pair's load, the cold start, the timed passes, the
    per-layer and profiled passes where it ran them, the rescoring); its
    CPU seconds a timed pass, its main thread's and its finisher threads'
    (born in the timed window); the card's SM clock, power and temperature
    before and after."""
    n = len(proc["pass_s"])

    def secs(role):
        return sum(t["user_s"] + t["sys_s"] for t in proc["threads"]
                   if t["role"] == role) / n

    def card(k):
        c = proc["window"][k]["card"] or {}
        return (f"{c.get('sm_mhz')} MHz {c.get('power_w')} W "
                f"{c.get('temp_c')} C")
    phases = ", ".join(f"{k} {v:.2f}" for k, v in proc["phases_s"].items())
    return (f"{proc['wall_s']:.2f} s ({phases}); a timed pass "
            f"{sum(p['cpu_s'] for p in proc['passes']) / n:.3f} CPU s, main "
            f"thread {secs('main'):.3f}, finisher "
            f"{secs('born in the window'):.3f}; card {card('before')} -> "
            f"{card('after')}")


def report(results: list, metrics: dict):
    """Print one call's summary: each cell's values and moves, each run's
    walls, peaks and process levels, each cell's shared share and
    per-layer metrics, and the bounds within the call."""
    s = summarize(results, metrics)
    for cell, ms in s["cells"].items():
        for m, (vals, move) in ms.items():
            print(f"{cell} {m}: {vals} (spread {100 * spread(vals):.2f}% "
                  f"of the median; three runs in a row: "
                  f"{[round(100 * t, 2) for t in threes(vals)]}%)",
                  flush=True)
    for run in dict.fromkeys(r["run"] for r in results):
        walls = [(r["cell"], r["wall_s"]) for r in results
                 if r["run"] == run]
        each = ", ".join(f"{c} {w} s" for c, w in walls)
        print(f"run {run}: {sum(w for _, w in walls):.1f} s for "
              f"{len(walls)} cells ({each})", flush=True)
    for r in results:
        if peaks(r["detail"]):
            print(f"run {r['run']} {r['cell']}: peak GiB reserved / "
                  f"allocated, by process: {peaks(r['detail'])}", flush=True)
        procs = (r["detail"] or {}).get("processes") or []
        if not procs:
            continue
        between = ""
        if len(procs) > 1:
            out, inside = process_spreads(r["detail"])
            between = (f"; between processes {100 * out:.2f}%, inside "
                       f"them {100 * inside:.2f}% (median)")
        print(f"run {r['run']} {r['cell']}: process levels "
              f"{[round(x, 4) for x in levels(r['detail'])]} s{between}",
              flush=True)
        for i, p in enumerate(procs):
            if "threads" in p:  # runs recorded before the records had it
                print(f"  process {i}: {where(p)}", flush=True)
    for cell in dict.fromkeys(r["cell"] for r in results):
        sh = shared(results, cell)
        if sh:
            print(f"{cell}: sd of the runs' means {100 * sh[0]:.2f}%, "
                  f"{100 * sh[1]:.2f}% if each unit of a run were drawn "
                  f"alone, {100 * sh[2]:.2f}% shared by a run's units",
                  flush=True)
        for k, (lo, mid, hi) in layer_ranges(results, cell).items():
            print(f"{cell} layer {k}: {lo}-{hi} [{mid}]", flush=True)
    print(f"bounds within the call: {json.dumps(s['bounds'])}", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(prog="bench_runs")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--cells", help="comma-separated cells (default the "
                                   "admitted ones, the file's workloads)")
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "bench_runs"))
    p.add_argument("--summarize", nargs="+", metavar="RUNS_JSONL",
                   help="run nothing: print the summary of the runs these "
                        "files record (the runs.jsonl of earlier calls, "
                        "one a call) and the rule's verdict over them")
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    metrics = bench["metrics"]
    work = bench["workloads"]
    if args.cells:
        names = args.cells.split(",")
        known = {w["name"]: w for w in work + bench.get("left_out", [])}
        unknown = set(names) - set(known)
        if unknown:
            p.error(f"no such cells: {sorted(unknown)}")
        work = [known[n] for n in names]
    if args.summarize:
        calls = []
        for path in args.summarize:
            with open(path) as f:
                calls.append([json.loads(ln) for ln in f if ln.strip()])
    else:
        if not work:
            p.error("BENCHMARK.json admits no cell: name cells with "
                    "--cells")
        os.makedirs(args.out, exist_ok=True)
        results = []
        calls = [results]
        with open(os.path.join(args.out, "runs.jsonl"), "a") as log:
            for run in range(args.runs):
                t0 = time.time()
                for w in work:
                    r = run_cell(shlex.split(w["command"]) + extra,
                                 os.path.join(args.out,
                                              f"run{run}_{w['name']}"))
                    r.update(run=run, cell=w["name"])
                    results.append(r)
                    log.write(json.dumps(r) + "\n")
                    log.flush()
                    print(f"run {run} {w['name']}: rc {r['rc']}, "
                          f"{r['wall_s']} s, {r['line']}", flush=True)
                print(f"run {run}: {time.time() - t0:.1f} s for "
                      f"{len(work)} cells", flush=True)
    for i, results in enumerate(calls, 1):
        print(f"call {i}: {len(results)} runs", flush=True)
        report(results, metrics)
    adm = admission(calls, metrics)
    for cell, v in adm["cells"].items():
        for i, mv in enumerate(v["moves"], 1):
            moved = ", ".join(f"{m} {100 * x:.2f}% (limit "
                              f"{100 * limit(m):.0f}%)"
                              for m, x in mv.items())
            print(f"{cell} call {i}: largest three-run move {moved}",
                  flush=True)
        print(f"{cell}: " + ("; ".join(["not admitted"] + v["why"])
                             if v["why"] else "admitted"), flush=True)
    print(json.dumps(dict(admitted=adm["admitted"], bounds=adm["bounds"])),
          flush=True)
    failed = [(i, r["run"], r["cell"]) for i, results in enumerate(calls, 1)
              for r in results if not correct(r)]
    if failed:
        print(f"failed (call, run, cell): {failed}", file=sys.stderr,
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
