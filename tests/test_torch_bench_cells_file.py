"""The port's benchmark file and its one-cell entry, on the CPU:
BENCHMARK.json as the cells' one definition, the seeded generators against
bench_inputs' draws, one cell end to end at a tiny size held to the JAX
package's output (tests/torch_bench_goldens.py, the script that gives the
cells' gates), the gate, the plain rescoring, the launchers, and the
arithmetic of the profile's summary and of the bounds."""

import contextlib
import io
import json
import os
import shlex
import subprocess
import sys

import numpy as np
import pytest

from segalign_tpu_torch import bench, bench_cells, bench_inputs
from segalign_tpu_torch.io.encode import revcomp_codes
from segalign_tpu_torch.scripts import bench_runs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_bench_goldens  # noqa: E402  (imports the JAX package)

CELL = "pair-repeat1x-4M-native"
TINY_MBP = 0.05


@pytest.fixture(scope="module")
def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_file_cells(benchmark):
    """Every workload is a cell that bench_cells reads, runnable by its
    command, with what the benchmark's record needs."""
    work = benchmark["workloads"] + benchmark["left_out"]
    cells = bench_cells.cells()
    assert [w["name"] for w in work] == list(cells)
    assert work[0]["name"] == CELL
    assert all(w["left_out"] for w in benchmark["left_out"])
    assert bench_cells.metric_units() == {"query_mbp_per_s": "Mbp/s",
                                          "peak_device_gib": "GiB"}
    for m, spec in benchmark["metrics"].items():
        assert spec["better"] in ("higher", "lower")
        assert spec["bound"] in (0.05, 0.10, 0.15), m
    for w in work:
        c = cells[w["name"]]
        assert w["chips"] == 1
        assert w["config"] in benchmark["configs"]
        assert w["source"] and len(w["source"]) <= 200
        assert w["reduced"] and all(w["reduced"])
        assert w["why"] and w["gate_from"] and w["traffic"]
        assert c.kind in ("pair", "cli") and c.passes >= 3
        assert c.inputs in (bench_inputs.FAMILIES if c.kind == "pair"
                            else bench_inputs.SCALE_INPUTS)
        # a golden for every count the cell reports, none left unrecorded
        assert c.gate and all(v is not None for v in c.gate.values())
        assert set(c.gate) >= ({"hsps", "digest"} if c.kind == "pair"
                               else {"hsps", "sha256"})
        argv = shlex.split(w["command"])
        assert argv[:3] == ["python", "-m", "segalign_tpu_torch.bench"]
        assert argv[argv.index("--cell") + 1] == w["name"]
    with pytest.raises(SystemExit):
        bench_cells.cell("no-such-cell")


@pytest.mark.parametrize("family", bench_inputs.FAMILIES)
def test_seed_2024_draws_bench_inputs(family):
    got = bench_cells.make_pair(family, 0.3, 0.3)
    want = bench_inputs.make_inputs(family, 0.3, 0.3)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    if family == "repeat-1x":
        for g, w in zip(got, bench_inputs.load_inputs(0.3, 0.3)):
            np.testing.assert_array_equal(g, w)
    other = bench_cells.make_pair(family, 0.3, 0.3, seed=2025)
    assert not np.array_equal(other[0], got[0])


def test_seed_2024_writes_the_scale_inputs(tmp_path, monkeypatch):
    """write_scale_pair at seed 2024 writes write_scale_inputs' bytes (each
    layout drawn small), and another seed other bytes."""
    for name, (_, _, rr, qr) in list(bench_inputs.SCALE_INPUTS.items()):
        monkeypatch.setitem(bench_inputs.SCALE_INPUTS, name,
                            (0.2, 0.1, rr, qr))
        paths = [str(tmp_path / f"{name}.{k}.fa") for k in "abcdef"]
        bench_inputs.write_scale_inputs(name, *paths[:2])
        bench_cells.write_scale_pair(name, *paths[2:4], 0.2, 0.1)
        bench_cells.write_scale_pair(name, *paths[4:], 0.2, 0.1, seed=7)
        data = [open(p, "rb").read() for p in paths]
        assert data[0] == data[2] and data[1] == data[3]
        assert data[4] != data[0]
        assert data[0].count(b">") == rr[1]
    with pytest.raises(ValueError):
        bench_cells.write_scale_pair("scale-3", *paths[:2], 0.2, 0.1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """BENCHMARK.json with its first cell cut to TINY_MBP x TINY_MBP and one
    pass, and as its gate what the JAX package gives for that pair
    (torch_bench_goldens.jax_gate, as for the real cells)."""
    doc = bench_cells.load()
    w = doc["workloads"][0]
    w.update(ref_mbp=TINY_MBP, query_mbp=TINY_MBP, passes=1,
             gate=torch_bench_goldens.jax_gate(w["inputs"], TINY_MBP,
                                               TINY_MBP))
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(doc))
    return str(path), w["gate"]


def run_tiny(tiny, monkeypatch, *argv):
    """bench.main on the tiny benchmark file: exit code, stdout lines."""
    monkeypatch.setattr(bench_cells, "BENCHMARK", tiny[0])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--cell", CELL, "--device", "cpu", *argv])
    return rc, out.getvalue().strip().splitlines()


def test_cell_matches_jax_on_the_cpu(tiny, monkeypatch):
    """One cell at a tiny size: every metric printed by name with its unit
    (the card's own as not measured), a detail line, and a last line that
    the JAX package's seeds, hits, HSPs and HSP digest hold to correct."""
    rc, out = run_tiny(tiny, monkeypatch)
    assert rc == 0
    for m, unit in bench_cells.metric_units().items():
        line = [ln for ln in out if ln.startswith(f"metric {m}: ")]
        assert len(line) == 1, m
        assert ("not measured" in line[0] if m == "peak_device_gib"
                else f" {unit} (" in line[0]), line[0]
    last, detail = json.loads(out[-1]), json.loads(out[-2])
    assert last["cell"] == CELL and last["seed"] == 2024
    assert last["correct"] is True
    assert last["units"] == bench_cells.metric_units()
    assert last["device"] == dict(platform="cpu", kind="cpu", count=0)
    assert last["query_mbp_per_s"] > 0 and last["peak_device_gib"] is None
    assert detail["cold_start_s"] > detail["cold_pass_s"] > 0
    assert detail["gate"] == "golden and rescored"
    assert detail["failures"] == []
    assert detail["counts"] == tiny[1] and tiny[1]["hsps"] > 0
    assert set(detail["layers"]["stages_s"]) >= {"seeds", "plan", "extend",
                                                 "pack", "host_dedup"}
    assert detail["profile"] is None


def test_another_seed_is_rescored(tiny, monkeypatch):
    """At another seed there is no golden: every HSP is rescored."""
    rc, out = run_tiny(tiny, monkeypatch, "--seed", "2025")
    last, detail = json.loads(out[-1]), json.loads(out[-2])
    assert rc == 0 and last["correct"] is True and last["seed"] == 2025
    assert detail["gate"] == "rescored" and detail["counts"]["hsps"] > 0
    assert detail["counts"] != tiny[1]


def test_gate_fails_a_count_off_by_one(tiny, monkeypatch, capsys):
    """The cell is held to its gate at seed 2024: one HSP more than the
    JAX package gives, and another digest, each fail, with exit code 1."""
    assert bench_cells.check(tiny[1], tiny[1]) == []
    assert bench_cells.check(dict(sha256=None), dict(sha256="ab")) != []
    want = dict(tiny[1], hsps=tiny[1]["hsps"] + 1, digest="0" * 64)
    doc = json.load(open(tiny[0]))
    doc["workloads"][0]["gate"] = want
    path = os.path.join(os.path.dirname(tiny[0]), "off_by_one.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    rc, out = run_tiny((path, want), monkeypatch)
    assert rc == 1
    last, detail = json.loads(out[-1]), json.loads(out[-2])
    assert last["correct"] is False
    msgs = [f"{k} {tiny[1][k]!r}, expected {want[k]!r}"
            for k in ("hsps", "digest")]
    assert detail["failures"] == msgs
    err = capsys.readouterr().err
    assert all(f"gate: {CELL}: {m}" in err for m in msgs)


def test_rescoring_the_cli_segments(tmp_path):
    """The plain rescoring of the pairwise CLI's segments on both strands
    (a reverse-complemented copy of the reference planted in the query):
    every HSP rescores, and one score one more fails."""
    ref, query = bench_cells.make_pair("repeat-1x", 0.06, 0.06, seed=11)
    query = query.copy()
    query[10000:40000] = revcomp_codes(ref[20000:50000])
    recs = (bench_inputs.record_layout("chr", 3, len(ref)),
            bench_inputs.record_layout("q", 4, len(query)))
    bench_inputs.write_records_fasta(str(tmp_path / "r.fa"), ref, *recs[0])
    bench_inputs.write_records_fasta(str(tmp_path / "q.fa"), query,
                                     *recs[1])
    from segalign_tpu_torch.cli.run_segalign import main as cli_main
    with contextlib.chdir(tmp_path):
        assert cli_main(["r.fa", "q.fa", "--nogapped", "--markend",
                         "--device", "cpu", "--output", "o.seg"]) == 0
    data = (tmp_path / "o.seg").read_bytes()
    named = bench_cells.segments_hsps(data, *recs, len(query))
    assert min(len(v) for v in named.values()) > 0
    s = bench_inputs.aligner_settings("cpu")
    args = (ref, query, revcomp_codes(query))
    assert bench_cells.rescore_failures(*args, named, s["sub_mat"],
                                        s["hspthresh"], unique=False) == []
    named["h1_1_0"][0, 3] += 1
    bad = bench_cells.rescore_failures(*args, named, s["sub_mat"],
                                       s["hspthresh"], unique=False)
    assert bad[-1] == "1 HSPs fail the rescoring"


@pytest.mark.parametrize("name", ["run_segalign",
                                  "run_segalign_repeat_masker"])
def test_launchers_help(name, tmp_path):
    path = os.path.join(ROOT, "segalign_tpu_torch", "scripts", name)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([path, "--help"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"usage: {name} ")


def test_profile_summary():
    """Busy share, the device ops by time, and each idle gap named by the
    host stage that covered most of it (nrange, a count, names none)."""
    ms = 1_000_000
    events = [(10 * ms, 30 * ms, "k1"), (20 * ms, 40 * ms, "k2"),
              (60 * ms, 65 * ms, "k1"), (90 * ms, 100 * ms, "copy")]
    spans = [("seeds", 0, 12 * ms), ("h2d", 40 * ms, 58 * ms),
             ("nrange", 40 * ms, 60 * ms), ("host_dedup", 70 * ms, 75 * ms)]
    s = bench.summarize_profile(events, spans, 0, 100 * ms)
    assert s["pass_ms"] == 100 and s["busy_share"] == 0.45
    assert s["idle_ms"] == 55
    assert s["top_ops"][0] == dict(name="k1", ms=25.0, calls=2)
    assert [(g["ms"], g["at_ms"], g["stage"], g["covered"])
            for g in s["longest_gaps"]] == [
        (25.0, 65.0, "host_dedup", 0.2), (20.0, 40.0, "h2d", 0.9),
        (10.0, 0.0, "seeds", 1.0)]


def test_bounds_from_runs():
    """The smallest of 5, 10 and 15% that covers the largest move of any
    cell's value across runs; a cell past 15% is named."""
    def runs(cell, vals):
        return [dict(cell=cell, line=dict(query_mbp_per_s=v, x=None))
                for v in vals]
    metrics = dict(query_mbp_per_s={}, peak_device_gib={})
    s = bench_runs.summarize(runs("a", [1.0, 1.04, 1.02]) +
                             runs("b", [2.0, 2.08, 2.0]), metrics)
    assert s["bounds"]["query_mbp_per_s"] == dict(
        bound=0.05, largest_move=0.04, over=[])
    assert s["bounds"]["peak_device_gib"]["bound"] == 0.05
    s = bench_runs.summarize(runs("a", [1.0, 1.3, 1.1]), metrics)
    assert s["bounds"]["query_mbp_per_s"]["bound"] is None
    assert s["bounds"]["query_mbp_per_s"]["over"] == ["a"]
