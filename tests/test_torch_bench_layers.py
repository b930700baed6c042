"""The benchmark's per-layer metrics and its method, on the CPU:
BENCHMARK.json's layer_metrics against the cells and the code that reports
them, each cell's `why` against the kernels its route calls, the profile's
device time by kernel and by host stage from synthetic trace events, a
cell's per-layer values from a run's record, the metric's statistic,
bench_runs' bounds over every three runs in a row, the peak device
memory (reserved, the CUDA graphs' pools included, beside the allocated)
from a process and from the CLI's stats event, and the result refused
once the JAX side of the repo is loaded."""

import dataclasses
import json
import os
import re
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from segalign_tpu_torch import bench, bench_cells, bench_inputs, \
    logging_util
from segalign_tpu_torch.io.encode import revcomp_codes
from segalign_tpu_torch.ops import first_scan, gather, window_scan, \
    window_scan_wide
from segalign_tpu_torch.ops.launches import launch_counts
from segalign_tpu_torch.pipeline.device import DeviceAligner
from segalign_tpu_torch.pipeline.pairwise import PipelineStats
from segalign_tpu_torch.scripts import bench_runs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernels' names in the documents, by launch counter (ops/launches.py)
K_NAMES = {"K1": "first_scan", "K1s": "first_scan_seq", "K2": "gather_rows",
           "K3": "gather_rows_tile", "K4": "window_scan",
           "K4s": "window_scan_seq", "K5": "window_scan_wide"}
WRAPPERS = {"first_scan": first_scan.first_scan,
            "first_scan_seq": first_scan.first_scan_seq,
            "gather_rows": gather.gather_rows,
            "gather_rows_tile": gather.gather_rows_tile,
            "window_scan": window_scan.window_scan,
            "window_scan_seq": window_scan.window_scan_seq,
            "window_scan_wide": window_scan_wide.window_scan_wide}


@pytest.fixture(scope="module")
def doc():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def route(cell) -> str:
    return "device" if cell.device_seeding else "native"


def applies(name: str, cell) -> bool:
    """Whether bench.layer_values gives metric `name` for this cell."""
    r = route(cell)
    stages = {f"{k}_s" for k in bench.LAYER_STAGES[r]}
    kernels = {f"{s}_{u}" for s, _ in bench.LAYER_KERNELS[r]
               for u in ("device_ms", "launches")}
    every = {"seeds_device_ms", "extend_device_ms", "device_busy_share"}
    return (name in stages | kernels | every
            or (name == "outside_ungapped_s" and cell.kind == "cli"))


def test_layer_metrics_declared(doc):
    """Every per-layer metric has its unit, direction, layer and the
    end-to-end metric it moves, and a workloads list of admitted cells:
    exactly those the code reports it for; and the code reports each for
    some cell of the file, admitted or left out."""
    cells = bench_cells.cells()
    admitted = [w["name"] for w in doc["workloads"]]
    declared = bench_cells.layer_metrics()
    assert declared == doc["layer_metrics"]
    assert set(declared).isdisjoint(doc["metrics"])
    names = set()
    for c in cells.values():
        names |= {k for k in declared if applies(k, c)}
    assert names == set(declared)
    for name, spec in declared.items():
        assert spec["unit"] in ("s", "ms", "launches", "share"), name
        assert spec["better"] in ("higher", "lower"), name
        assert spec["layer"] in range(1, 8), name
        assert spec["moves"] in doc["metrics"], name
        assert spec["what"], name
        assert spec["device"] == name.endswith(
            ("_device_ms", "_launches", "_share")), name
        assert spec["workloads"] == [n for n in admitted
                                     if applies(name, cells[n])], name


def test_layer_kernels_are_launch_counters():
    counters = set(launch_counts())
    assert set(K_NAMES.values()) == counters == set(WRAPPERS)
    assert {k for k, _ in bench.TRACE_KERNELS} == counters
    for r in ("native", "device"):
        assert {c for _, c in bench.LAYER_KERNELS[r]} <= counters


def route_calls(device_seeding: bool, monkeypatch) -> set:
    """The main-path wrappers a pass of this route calls on a small pair
    (on the CPU each takes its plain version, and on a card each call is a
    launch): every module's name for each wrapper is replaced by a spy,
    and a call made inside another wrapper's plain version is not the
    route's."""
    called, depth = set(), [0]

    def spy(name, fn):
        def call(*a, **kw):
            if depth[0] == 0:
                called.add(name)
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        call.launches = fn.launches
        return call

    for name, fn in WRAPPERS.items():
        s = spy(name, fn)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("segalign_tpu_torch"):
                for attr, val in list(vars(mod).items()):
                    if val is fn:
                        monkeypatch.setattr(mod, attr, s)
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 3000).astype(np.uint8)
    query = rng.integers(0, 4, 3000).astype(np.uint8)
    query[500:1700] = ref[1000:2200]
    settings = dict(bench_inputs.aligner_settings("cpu"), chunk_size=1024)
    al = DeviceAligner(**settings, HBUF=1024, device_seeding=device_seeding)
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    hsps = sum(len(al.seed_and_filter(0, 2000, rev).hsps)
               for rev in (False, True))
    assert hsps > 0
    return called


def named_kernels(text: str) -> set:
    """The launch counters of the kernels a text names (K1-K5, K1s, K4s,
    ranges such as K1-K4 by their ends, and the counters' own names)."""
    got = {K_NAMES[m] for m in re.findall(r"\b(K[1-5]s?)\b", text)}
    return got | {c for c in K_NAMES.values()
                  if re.search(rf"\b{c}\b", text)}


@pytest.mark.parametrize("device_seeding", [False, True])
def test_why_names_only_the_route_kernels(device_seeding, monkeypatch, doc):
    """Each cell's `why` names only kernels its route launches: the
    wrappers a pass of that route calls, and the route's per-layer
    kernels are among them."""
    calls = route_calls(device_seeding, monkeypatch)
    r = "device" if device_seeding else "native"
    assert {c for _, c in bench.LAYER_KERNELS[r]} == calls
    cells = [c for c in bench_cells.cells().values()
             if c.device_seeding == device_seeding]
    assert cells
    for c in cells:
        w = next(w for w in doc["workloads"] + doc["left_out"]
                 if w["name"] == c.name)
        assert named_kernels(w["why"]) <= calls, (c.name, w["why"])
    assert named_kernels("K1-K4 and first_scan_seq") == {
        "first_scan", "window_scan", "first_scan_seq"}


def test_block1000_cell(doc):
    """The genome-scale CLI cell and its configuration: block-1000 through
    the launcher with 500 kb chunks, held to the device route's bytes."""
    c = bench_cells.cell("cli-block1000-native")
    assert (c.kind, c.inputs, c.ref_mbp, c.query_mbp) == (
        "cli", "block-1000", 1000, 1)
    assert bench_inputs.SCALE_INPUTS["block-1000"][:2] == (1000, 1)
    assert c.config == "segalign-chunk500k" and not c.device_seeding
    assert c.cli_args == ("--wga_chunk_size", "500000")
    assert doc["configs"]["segalign-chunk500k"] == dict(
        doc["configs"]["segalign-default"],
        cli_args=["--wga_chunk_size", "500000"])
    assert c.gate == {"hsps": 206900, "sha256": "d7a0656f31e9c5a8da322c05"
                      "1e1b17e4897951b39499858d3324f30c3f73aac1"}
    w = next(w for w in doc["workloads"] + doc["left_out"]
             if w["name"] == c.name)
    assert "H100" in w["gate_from"] and "1 Mbp" in " ".join(w["reduced"])
    assert "cli-block1000-native" in doc["correct"]


def test_profile_by_kernel_and_by_stage():
    """Device ms and launches of each main-path kernel from the trace's
    names, and the device ms of the ops each stage queued, by the host
    time of their launch (a launch outside every span, or one the trace
    did not link, counts for no stage)."""
    ms = 1_000_000
    k1s = "first_scan_seq_kernel(unsigned char const*, long)"
    k4s = "void window_scan_seq_kernel(Seqs, int const*)"
    k5 = "void carried_scan_kernel<false>(unsigned char const*, int)"
    events = [(10 * ms, 12 * ms, k1s, 5 * ms),
              (13 * ms, 16 * ms, k4s, 9 * ms),
              (20 * ms, 21 * ms, "void at::native::index_kernel", 1 * ms),
              (22 * ms, 26 * ms, k1s, 19 * ms),
              (30 * ms, 31 * ms, "Memcpy DtoH (Device -> Pinned)", None),
              (40 * ms, 41 * ms, k5, 39 * ms)]
    spans = [("seeds", 0, 4 * ms), ("extend", 4 * ms, 10 * ms),
             ("nrange", 8 * ms, 20 * ms), ("extend", 18 * ms, 20 * ms),
             ("host_dedup", 38 * ms, 40 * ms)]
    s = bench.summarize_profile(events, spans, 0, 50 * ms)
    assert s["kernels"]["first_scan_seq"] == dict(ms=6.0, launches=2)
    assert s["kernels"]["window_scan_seq"] == dict(ms=3.0, launches=1)
    assert s["kernels"]["window_scan_wide"] == dict(ms=1.0, launches=1)
    assert s["kernels"]["gather_rows"] == dict(ms=0.0, launches=0)
    assert s["stage_device_ms"] == {"seeds": 1.0, "extend": 9.0,
                                    "host_dedup": 1.0}
    assert s["launch_linked"] == round(5 / 6, 4)
    assert bench.kernel_of("void carried_scan_kernel<true>(x)") == \
        "window_scan"
    assert bench.kernel_of("gather_rows_tile_kernel(x)") == \
        "gather_rows_tile"
    assert bench.kernel_of("void at::native::elementwise_kernel") is None
    assert bench.is_launch("cudaLaunchKernel")
    assert bench.is_launch("cuLaunchKernel")
    assert not bench.is_launch("aten::cumsum")
    assert not bench.is_launch("bench_pass_start")


def test_profile_ops_by_stage(monkeypatch):
    """Each stage's device ops by name, from the same launches as its
    stage_device_ms: the STAGE_TOP first by device ms with their calls,
    the rest in one row, so that a stage's rows sum to its device ms; an
    op launched outside every span, or not linked, is in no stage."""
    monkeypatch.setattr(bench, "STAGE_TOP", 2)
    ms = 1_000_000
    sort, scan = "void cub::DeviceRadixSortOnesweepKernel", "cumsum_kernel"
    k1s = "first_scan_seq_kernel(unsigned char const*, long)"
    events = [(10 * ms, 13 * ms, sort, 1 * ms),
              (13 * ms, 14 * ms, scan, 2 * ms),
              (14 * ms, 16 * ms, sort, 3 * ms),
              (16 * ms, 16 * ms + ms // 2, "fill", 3 * ms),
              (17 * ms, 17 * ms + ms // 4, "copy", 3 * ms),
              (20 * ms, 26 * ms, k1s, 5 * ms),
              (27 * ms, 28 * ms, scan, 6 * ms),
              (30 * ms, 31 * ms, "Memcpy DtoH (Device -> Pinned)", None),
              (32 * ms, 33 * ms, "idle launch", 45 * ms)]
    spans = [("seeds", 0, 4 * ms), ("extend", 4 * ms, 10 * ms),
             ("nrange", 0, 10 * ms)]
    s = bench.summarize_profile(events, spans, 0, 50 * ms)
    assert s["stage_ops"] == {
        "seeds": [dict(name=sort, ms=5.0, calls=2),
                  dict(name=scan, ms=1.0, calls=1),
                  dict(name="(2 other ops)", ms=0.75, calls=2)],
        "extend": [dict(name=k1s, ms=6.0, calls=1),
                   dict(name=scan, ms=1.0, calls=1)]}
    for stage, rows in s["stage_ops"].items():
        assert sum(r["ms"] for r in rows) == pytest.approx(
            s["stage_device_ms"][stage])
    assert s["stage_device_ms"] == {"seeds": 6.75, "extend": 7.0}
    assert bench.summarize_profile([], spans, 0, ms)["stage_ops"] == {}


def record(cell_kind="pair", profile=True):
    """A run's record as bench._pair_cell / _cli_cell return it."""
    prof = None
    if profile:
        prof = dict(busy_share=0.1, top_ops=[], longest_gaps=[],
                    kernels={k: dict(ms=1.5, launches=3)
                             for k, _ in bench.TRACE_KERNELS},
                    stage_device_ms={"seeds": 2.0}, launch_linked=0.9)
    return dict(layers=dict(stages_s=dict(seeds=0.1, plan=0.01, extend=0.2,
                                          pack=0.03, host_dedup=0.04)),
                profile=prof,
                runs=[dict(dt=10.0, stage_s=2.0), dict(dt=12.0, stage_s=3.0),
                      dict(dt=11.0, stage_s=1.0)])


@pytest.mark.parametrize("name", ["cli-scale8-native",
                                  "pair-repeat1x-4M-device"])
def test_layer_values(name):
    """A cell's per-layer values by name: the device's None without a
    profile, a stage the trace linked no launch to 0, and a CLI cell's
    time outside the ungapped stage the median over its processes."""
    c = bench_cells.cell(name)
    declared = bench_cells.layer_metrics()
    for profile in (True, False):
        v = bench.layer_values(c, record(c.kind, profile))
        assert set(v) == {k for k in declared if applies(k, c)}
        for k, x in v.items():
            assert (x is None) == (declared[k]["device"] and not profile), k
    v = bench.layer_values(c, record(c.kind))
    assert v["seeds_s"] == 0.1 and v["extend_device_ms"] == 0.0
    assert v["seeds_device_ms"] == 2.0 and v["device_busy_share"] == 0.1
    if c.kind == "cli":
        assert v["outside_ungapped_s"] == 9.0 and v["k1s_launches"] == 3
    else:
        assert v["k4s_device_ms"] == 1.5 and "plan_s" not in v
    unlinked = record(c.kind)
    unlinked["profile"]["launch_linked"] = 0.0
    assert bench.layer_values(c, unlinked)["seeds_device_ms"] is None


def test_bounds_count_every_three_runs_in_a_row():
    """bench_runs applies the bounds' rule to every three runs in a row of
    a call: ten runs whose first three agree, but a later three move 30%,
    are over 15%; with three runs the move is theirs."""
    vals = [1.0, 1.02, 1.01, 1.0, 0.8, 1.1, 1.0, 1.0, 1.02, 1.01]
    threes = bench_runs.threes(vals)
    assert len(threes) == 8 and threes[0] < 0.05
    assert max(threes) == pytest.approx(0.3 / 1.0)
    s = bench_runs.summarize(
        [dict(cell="a", line=dict(query_mbp_per_s=v)) for v in vals],
        dict(query_mbp_per_s={}))
    assert s["bounds"]["query_mbp_per_s"]["bound"] is None
    assert s["bounds"]["query_mbp_per_s"]["over"] == ["a"]
    assert bench_runs.threes([1.0, 1.04]) == [pytest.approx(0.04 / 1.02)]


def rule_runs(cell, rates, peaks=None, ok=True):
    """A call's runs of one cell as runs.jsonl records them."""
    peaks = peaks or [0.26] * len(rates)
    return [dict(run=i, cell=cell, rc=0, line=dict(
        query_mbp_per_s=v, peak_device_gib=g, correct=ok))
        for i, (v, g) in enumerate(zip(rates, peaks))]


RULE_METRICS = dict(query_mbp_per_s={}, peak_device_gib={})
STILL = [20.0, 21.0, 20.5, 19.8, 21.2, 20.1, 20.9, 20.0, 21.5, 20.4]


def test_rule_admits_a_cell_that_holds_in_both_calls():
    """Two calls of ten runs, each three runs in a row within 15% (the
    largest 14.14%, so the bound is 15%) and the peak within 5%: admitted,
    and each call's largest move is given."""
    b = STILL[:5] + [18.4, 20.6] + STILL[7:]
    calls = [rule_runs("c", STILL), rule_runs("c", b)]
    a = bench_runs.admission(calls, RULE_METRICS)
    assert a["admitted"] == ["c"] and a["cells"]["c"]["why"] == []
    moves = [m["query_mbp_per_s"] for m in a["cells"]["c"]["moves"]]
    assert moves == [pytest.approx(max(bench_runs.threes(v)))
                     for v in (STILL, b)]
    assert moves[1] == pytest.approx(2.8 / 19.8) and moves[1] > 0.10
    assert a["bounds"]["query_mbp_per_s"] == dict(
        bound=0.15, largest_move=round(moves[1], 4))
    assert a["bounds"]["peak_device_gib"] == dict(bound=0.05,
                                                  largest_move=0.0)


def test_rule_refuses_one_three_run_move_in_one_call():
    """One three runs in a row past 15% in one call keeps the cell out,
    though the other call and every other three hold; so do fewer than
    ten runs, one call alone, and a run that is not correct, which admits
    nothing on its call."""
    b = STILL[:4] + [19.0, 20.5, 22.2] + STILL[7:]
    a = bench_runs.admission([rule_runs("c", STILL), rule_runs("c", b)],
                             RULE_METRICS)
    assert a["admitted"] == [] and len(a["cells"]["c"]["why"]) == 1
    assert a["cells"]["c"]["why"][0] == (
        "call 2: query_mbp_per_s moved 15.61% over three runs in a row, "
        "past 15%")
    assert sum(t > 0.15 for t in bench_runs.threes(b)) == 1
    assert a["bounds"]["query_mbp_per_s"] == dict(bound=None,
                                                  largest_move=None)
    for calls in ([rule_runs("c", STILL)],
                  [rule_runs("c", STILL), rule_runs("c", STILL[:9])],
                  [rule_runs("c", STILL), rule_runs("c", STILL)
                   + rule_runs("d", STILL, ok=False)]):
        a = bench_runs.admission(calls, RULE_METRICS)
        assert a["admitted"] == [], calls


def test_rule_refuses_a_peak_that_moves_6_percent():
    """The peak's limit is 5%: a reserved peak that moves 6% over three
    runs in a row keeps the cell out, and within one call it is named
    over its limit where the rate's 15% would let it pass."""
    peaks = [0.25] * 4 + [0.265] + [0.25] * 5
    calls = [rule_runs("c", STILL), rule_runs("c", STILL, peaks)]
    a = bench_runs.admission(calls, RULE_METRICS)
    assert a["admitted"] == []
    assert a["cells"]["c"]["moves"][1]["peak_device_gib"] == \
        pytest.approx(0.06)
    assert a["cells"]["c"]["why"] == [
        "call 2: peak_device_gib moved 6.00% over three runs in a row, "
        "past 5%"]
    s = bench_runs.summarize(calls[1], RULE_METRICS)
    assert s["bounds"]["peak_device_gib"]["over"] == ["c"]
    assert s["bounds"]["query_mbp_per_s"] == dict(
        bound=None, largest_move=None, over=[])


def test_rule_bound_over_the_admitted_cells_only(tmp_path, capsys):
    """With one of two cells out, each bound is set over the admitted
    one's moves alone: the cell out does not leave it None, nor widen
    it. --summarize reads a runs.jsonl a call and prints each cell's
    verdict and, last, the admitted cells and the bounds."""
    tight = [20.0, 20.2, 20.4] * 3 + [20.0]
    wild = STILL[:3] + [14.0] + STILL[4:]
    calls = [rule_runs("a", tight) + rule_runs("b", STILL),
             rule_runs("a", tight) + rule_runs("b", wild)]
    a = bench_runs.admission(calls, RULE_METRICS)
    assert a["admitted"] == ["a"]
    assert a["bounds"]["query_mbp_per_s"] == dict(bound=0.05,
                                                  largest_move=0.0198)
    paths = []
    for i, runs in enumerate(calls):
        paths.append(str(tmp_path / f"runs{i}.jsonl"))
        with open(paths[-1], "w") as f:
            f.writelines(json.dumps(dict(r, wall_s=1.0, detail=None)) + "\n"
                         for r in runs)
    assert bench_runs.main(["--summarize", *paths,
                            "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "a: admitted" in out
    assert any(ln.startswith("b: not admitted; call 2: query_mbp_per_s")
               for ln in out)
    assert ("b call 1: largest three-run move query_mbp_per_s "
            f"{100 * max(bench_runs.threes(STILL)):.2f}% (limit 15%), "
            "peak_device_gib 0.00% (limit 5%)") in out
    assert json.loads(out[-1]) == dict(admitted=["a"], bounds=a["bounds"])


def test_process_levels_and_spreads():
    """bench_runs' summary of a run of a pair cell in several processes:
    each process's level is the median of its timed passes' seconds, the
    spread between the levels against the median spread inside them, what
    each spent (its phases, its threads' CPU seconds, its finisher threads
    born in the timed window apart), and the share of a cell's spread over
    runs that its processes share."""
    def proc(pass_s):
        threads = [dict(role="main", user_s=0.5, sys_s=0.1),
                   dict(role="born in the window", user_s=0.2, sys_s=0.0),
                   dict(role="from the start", user_s=0.01, sys_s=0.0)]
        card = dict(sm_mhz=1980.0, power_w=120.0, temp_c=40.0)
        return dict(pass_s=pass_s, passes=[dict(cpu_s=0.3)] * len(pass_s),
                    threads=threads, wall_s=9.5,
                    phases_s=dict(start=6.0, timed=1.25),
                    window=dict(before=dict(card=card),
                                after=dict(card=None)))
    detail = dict(processes=[proc([0.2, 0.3, 0.22]),
                             proc([0.3, 0.3, 0.33])])
    assert bench_runs.levels(detail) == [0.22, 0.3]
    assert bench_runs.levels(dict(processes=None)) == bench_runs.levels(
        None) == []
    between, inside = bench_runs.process_spreads(detail)
    assert between == pytest.approx(0.08 / 0.26)
    assert inside == pytest.approx((0.1 / 0.22 + 0.03 / 0.3) / 2)
    assert bench_runs.where(detail["processes"][1]) == (
        "9.50 s (start 6.00, timed 1.25); a timed pass 0.300 CPU s, main "
        "thread 0.200, finisher 0.067; card 1980.0 MHz 120.0 W 40.0 C -> "
        "None MHz None W None C")
    # runs whose processes move together: nearly all of the runs' sd is
    # shared by their processes; a cell of one process counts its passes
    runs = [dict(cell="c", detail=dict(processes=[proc([x]), proc([x + d])]))
            for x, d in [(1.0, .01), (1.2, -.01), (0.9, .01), (1.1, -.01)]]
    runs += [dict(cell="d", detail=dict(pass_s=[1.0, 1.1], processes=[
        proc([1.0, 1.1])]))] * 2
    sd, alone, common = bench_runs.shared(runs, "c")
    means = [1.005, 1.195, 0.905, 1.095]
    assert sd == pytest.approx(np.std(means, ddof=1) / np.mean(means))
    assert alone == pytest.approx(np.std([0, .01], ddof=1) / 2 ** .5
                                  / np.mean(means))
    assert common == pytest.approx((sd ** 2 - alone ** 2) ** .5)
    assert bench_runs.shared(runs, "d") is None  # fewer than 3 runs
    runs.append(runs[-1])
    assert bench_runs.shared(runs, "d") == (0.0, pytest.approx(
        np.std([1.0, 1.1], ddof=1) / 2 ** .5 / 1.05), 0.0)


def test_layer_ranges():
    """bench_runs gives each per-layer metric of a cell as (min, median,
    max) over its runs' result lines; a metric null in every run (no
    card) and another cell's runs are left out."""
    runs = [dict(cell="c", line=dict(layers=dict(seeds_s=x, k1s_ms=None)))
            for x in (0.3, 0.1, 0.2)]
    runs += [dict(cell="d", line=dict(layers=dict(seeds_s=9.0))),
             dict(cell="c", line=None)]
    assert bench_runs.layer_ranges(runs, "c") == dict(seeds_s=(0.1, 0.2,
                                                               0.3))
    assert bench_runs.layer_ranges(runs, "e") == {}


def test_thread_clock_sees_a_thread_born_in_the_window():
    """_ThreadClock records each thread of the process over its window
    from /proc/self/task: the main thread, the threads there from its
    start, and a thread born inside it and read while it lives (peek),
    with the CPU seconds it burned; a thread born and ended between two
    readings is not seen."""
    clock = bench._ThreadClock()
    clock.start()
    spun, release = threading.Event(), threading.Event()

    def spin():  # 0.3 CPU s of its own (5 s of wall at most), then waits
        t0 = time.monotonic()
        while time.thread_time() < 0.3 and time.monotonic() - t0 < 5:
            pass
        spun.set()
        release.wait(30)
    read = threading.Thread(target=spin)
    read.start()
    assert spun.wait(30)
    clock.peek()
    release.set()
    unread = threading.Thread(target=time.sleep, args=(0.01,))
    unread.start()
    for t in (read, unread):
        t.join(timeout=30)
        assert not t.is_alive()
    # join returns once the thread's Python state is released, which can be
    # before the kernel drops its task from /proc/self/task
    t0 = time.monotonic()
    while (os.path.exists(f"/proc/self/task/{unread.native_id}")
           and time.monotonic() - t0 < 30):
        time.sleep(0.01)
    clock.stop()
    threads = clock.report()
    assert [x["tid"] for x in threads if x["role"] == "main"] == [
        os.getpid()]
    born = [x for x in threads if x["role"] == "born in the window"]
    assert [x["tid"] for x in born] == [read.native_id]
    assert born[0]["user_s"] + born[0]["sys_s"] >= 0.2
    assert {x["tid"] for x in threads} >= set(clock.first)
    assert all(x["user_s"] >= 0 and x["sys_s"] >= 0 for x in threads)


def test_total_rate():
    """query_mbp_per_s is the Mbp of every timed pass over their seconds
    in all: each slowed pass lowers it by its whole wall, where a rate
    from the median pass would not move."""
    assert bench.total_rate(4.0, [0.2, 0.2, 0.2, 0.2]) == pytest.approx(20)
    assert bench.total_rate(4.0, [0.2, 0.2, 0.2, 0.2, 1.0]) == \
        pytest.approx(20 / 1.8)
    assert bench.total_rate(4.0, [0.2, 0.2, 0.2, 1.0, 1.0]) == \
        pytest.approx(20 / 2.6)
    assert bench.total_rate(1.0, [1.0, 2.0, 3.0, 10.0]) == 0.25


@pytest.mark.parametrize("how", ["nothing", "planted", "command line"])
def test_result_refused_with_jax_loaded(how, monkeypatch, capsys):
    """The result line says correct false, and the run exits 1, when a
    module of the JAX side of the repo was loaded by the end of the run:
    one the run planted, or any at all when run from the command line
    (this test process holds the JAX package). One the caller had loaded
    before the call is the caller's."""
    def fake_run(name, seed, device):
        if how == "planted":
            monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return dict(line=dict(cell=name, seed=seed, correct=True),
                    detail=dict(cell=name, failures=[]))
    monkeypatch.delitem(sys.modules, "flax", raising=False)
    monkeypatch.setitem(sys.modules, "segalign_tpu", sys.modules.get(
        "segalign_tpu", types.ModuleType("segalign_tpu")))
    monkeypatch.setattr(bench, "run_cell", fake_run)
    monkeypatch.setattr(bench, "_build_all", lambda device: None)
    argv = ["--cell", "pair-repeat1x-4M-native", "--device", "cpu"]
    if how == "command line":
        monkeypatch.setattr(sys, "argv", ["bench", *argv])
        rc = bench.main()
    else:
        rc = bench.main(argv)
    captured = capsys.readouterr()
    last, detail = (json.loads(ln) for ln in
                    captured.out.strip().splitlines()[::-1][:2])
    refused = how != "nothing"
    assert rc == int(refused) and last["correct"] is not refused
    assert bool(detail["failures"]) is refused
    assert ("the JAX side of the repo was loaded" in captured.err) is refused


def test_admitted_and_left_out(doc):
    """An admitted workload carries no left_out key; a left_out cell says
    why it is out. Cell 1 runs first wherever it stands, and the cell
    gated on the port's own output is not admitted."""
    assert all("left_out" not in w for w in doc["workloads"])
    assert all(w["left_out"] for w in doc["left_out"])
    first = (doc["workloads"] or doc["left_out"])[0]
    assert first["name"] == "pair-repeat1x-4M-native"
    assert "cli-block1000-native" in [w["name"] for w in doc["left_out"]]


def test_peak_is_the_reserved_memory(monkeypatch):
    """A process's peak for peak_device_gib is max_memory_reserved, which
    holds the CUDA graphs' private pools; max_memory_allocated is kept
    beside it; without a card neither (torch.cuda's counters
    monkeypatched on the CPU)."""
    monkeypatch.setattr(torch.cuda, "max_memory_reserved",
                        lambda device=None: 300)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: 200)
    cuda = torch.device("cuda", 0)
    assert bench._peak(cuda) == 300 and bench._peak_allocated(cuda) == 200
    cpu = torch.device("cpu")
    assert bench._peak(cpu) is None and bench._peak_allocated(cpu) is None


@pytest.mark.parametrize("cards", [0, 2])
def test_stats_event_carries_both_peaks(cards, monkeypatch, capsys):
    """The pipelines' stats event lists every card's allocated peak
    (peak_device_bytes) and reserved peak (peak_reserved_bytes), by index;
    both empty in a process that has not used CUDA."""
    monkeypatch.setattr(logging_util, "_ENABLED", True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 10 + i)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda i: 20 + i)
    PipelineStats(num_hsps=3).log(1.5)
    ev = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert ev["event"] == "stats" and ev["hsps"] == 3
    assert ev["peak_device_bytes"] == [10 + i for i in range(cards)]
    assert ev["peak_reserved_bytes"] == [20 + i for i in range(cards)]


def test_cli_cell_peak_from_stats(tmp_path, monkeypatch):
    """A CLI cell's peak_device_gib is the largest peak_reserved_bytes of
    its processes' stats events, and its detail line keeps each process's
    reserved and allocated peaks (the launcher's processes faked: each
    writes an output with no segments and one stats event)."""
    c = dataclasses.replace(bench_cells.cell("cli-scale8-native"),
                            ref_mbp=0.2, query_mbp=0.1)
    # the first process holds the most
    want = [300 + 100 * i for i in range(c.passes)][::-1]
    reserved = iter(want)

    def launcher(argv, cwd, env, stdout, stderr, text):
        with open(argv[argv.index("--output") + 1], "wb") as f:
            f.write(b"# segalign end-of-file\n")
        r = next(reserved)
        st = dict(event="stats", seeds=5, seed_hits=4, hsps=0, seconds=0.5,
                  launches={}, peak_device_bytes=[r - 100],
                  peak_reserved_bytes=[r])
        return types.SimpleNamespace(returncode=0, stderr=json.dumps(
            st, separators=(",", ":")) + "\n")
    monkeypatch.setattr(bench.subprocess, "run", launcher)
    monkeypatch.setattr(bench, "_layers", lambda run_pass: dict(stages_s={}))
    monkeypatch.setattr(bench, "_profile", lambda run_pass, device: None)
    r = bench._cli_cell(c, 7, torch.device("cpu"), str(tmp_path))
    assert [p["peak"] for p in r["runs"]] == want
    assert [p["peak_allocated"] for p in r["runs"]] == [
        w - 100 for w in want]
    assert r["peak"] == want[0]
    monkeypatch.setattr(bench, "_cli_cell", lambda *a: r)
    out = bench.run_cell(c.name, 7, torch.device("cpu"))
    assert out["line"]["correct"] is True
    assert out["line"]["peak_device_gib"] == round(want[0] / 2**30, 4)
    assert out["detail"]["peaks"] == [
        dict(reserved_bytes=w, allocated_bytes=w - 100) for w in want]
    assert bench_runs.peaks(out["detail"]).startswith(
        f"{want[0] / 2**30:.4f} / {(want[0] - 100) / 2**30:.4f}, ")
    assert bench_runs.peaks(dict(peaks=[dict(
        reserved_bytes=None, allocated_bytes=None)])) == "none / none"
    assert bench_runs.peaks(None) == ""
