"""The port's benchmark (segalign_tpu_torch/bench.py) and what it needs of
the aligner, against the root bench.py and the JAX aligner, on the CPU.

The cells themselves (run_config against the JAX bench's) are in
test_torch_bench_cells*.py, one file a cell, so that the test workers
spread them."""

import ast
import inspect
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the JAX package's benchmark)
from segalign_tpu.pipeline.device import DeviceAligner as JaxAligner  # noqa
from segalign_tpu_torch import bench as port_bench  # noqa: E402
from segalign_tpu_torch import bench_inputs  # noqa: E402
from segalign_tpu_torch.io.encode import revcomp_codes  # noqa: E402
from segalign_tpu_torch.pipeline import device as devmod  # noqa: E402
from segalign_tpu_torch.pipeline.device import DeviceAligner  # noqa: E402
from test_torch_pipeline import _kw, dense_pair, make_pair  # noqa: E402

# the environment of the small run (0.3 x 0.2 Mbp, one steady pass)
SMALL_ENV = dict(BENCH_REF_MBP="0.3", BENCH_QUERY_MBP="0.2", BENCH_SWEEP="0",
                 BENCH_LEGACY="0", BENCH_STEADY_REPS="1",
                 BENCH_GAPPED_MAX="200")


@pytest.fixture(scope="module")
def pair():
    """The repeat-1x pair at 0.3 x 0.2 Mbp and the query's reverse
    complement."""
    ref, query = bench_inputs.load_inputs(0.3, 0.2)
    return ref, query, revcomp_codes(query)


def jax_draws(name, ref_mbp, query_mbp):
    """The pair the root bench.py's main draws for one family (its
    load_inputs, sweep and legacy sections, with its generators)."""
    if name == "repeat-1x":
        rng = np.random.default_rng(2024)
        lib = bench.make_repeat_library(rng)
        ref = bench.synth_genome_repeats(rng, int(ref_mbp * 1e6), lib)
        return ref, bench.synth_genome_repeats(
            rng, int(query_mbp * 1e6), lib, homolog_from=ref)
    if name == "legacy-planted":
        rng = np.random.default_rng(2024)
        r3 = bench.synth_genome(rng, int(ref_mbp * 1e6))
        return r3, bench.synth_genome(rng, int(query_mbp * 1e6),
                                      homolog_from=r3)
    mult = {"repeat-0.5x": 0.5, "repeat-4x": 4.0}[name]
    n = int(min(ref_mbp, 2.0) * 1e6)
    rng = np.random.default_rng(7000 + int(mult * 10))
    lib = bench.make_repeat_library(rng)
    r2 = bench.synth_genome_repeats_sweep(rng, n, lib, repeat_mult=mult)
    return r2, bench.synth_genome_repeats_sweep(rng, n, lib, homolog_from=r2,
                                                repeat_mult=mult)


@pytest.mark.parametrize("name", bench_inputs.FAMILIES)
def test_make_inputs_equal_the_jax_bench_draws(name):
    for sizes in ((0.3, 0.2), (2.5, 0.2)):   # the sweep cuts n at 2 Mbp
        if sizes[0] > 1 and name in ("repeat-1x", "legacy-planted"):
            continue
        got = bench_inputs.make_inputs(name, *sizes)
        want = jax_draws(name, *sizes)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        bench_inputs.make_inputs("repeat-2x")


def test_window_256_matches_jax_and_window_512(pair, monkeypatch):
    """One strand of the pair: the JAX aligner at window 256, the port at
    256 and the port at 512 give the same HSPs."""
    monkeypatch.delenv("SEGALIGN_WINDOW", raising=False)
    ref, query, qrc = pair
    s = bench_inputs.aligner_settings("cpu")
    s.pop("device")
    jax_al = JaxAligner(window=256, **s)
    ports = [port_bench.make_aligner("cpu", window=w) for w in (256, 512)]
    out = []
    for al in [jax_al, *ports]:
        al.set_ref(ref)
        al.set_query(query, qrc)
        out.append(al.seed_and_filter(0, len(query) - al.seed_size,
                                      rev=False))
    assert ports[0].window == 256 and ports[1].window == 512
    want = out[0]
    assert len(want.hsps) > 0
    for got in out[1:]:
        assert (got.num_hits, got.num_seeds) == (want.num_hits,
                                                 want.num_seeds)
        np.testing.assert_array_equal(got.hsps, want.hsps)


@pytest.mark.parametrize("window", [0, 100, 4096])
def test_window_out_of_range_raises(window):
    with pytest.raises(ValueError, match="window"):
        port_bench.make_aligner("cpu", window=window)


@pytest.mark.parametrize("depth", [1, 4])
def test_serial_map_chunks_equals_the_finisher_thread(monkeypatch, depth):
    """SEGALIGN_OVERLAP=0: the same results, and on_result fires in work
    order, as with the finisher thread (a small pair, ten chunk-strands)."""
    ref, query = make_pair(np.random.default_rng(7))
    qrc = revcomp_codes(query)
    al = DeviceAligner(device="cpu", **_kw(10**9))
    al.set_ref(ref)
    al.set_query(query, qrc)
    work = bench_inputs.chunk_work(query, 512)
    runs = {}
    for overlap in ("1", "0"):
        monkeypatch.setenv("SEGALIGN_OVERLAP", overlap)
        order = []
        res = al.map_chunks(work, depth=depth,
                            on_result=lambda i, r: order.append((i, r)))
        assert [i for i, _ in order] == list(range(len(work)))
        assert all(r is res[i] for i, r in order)
        runs[overlap] = res
    assert sum(len(r.hsps) for r in runs["1"]) > 0
    for a, b in zip(runs["1"], runs["0"]):
        assert (a.num_hits, a.num_seeds) == (b.num_hits, b.num_seeds)
        np.testing.assert_array_equal(a.hsps, b.hsps)


NATIVE_STAGES = {"seeds", "plan", "extend", "pack", "d2h", "host_dedup"}
DEVICE_STAGES = {"seeds", "plan", "extend", "nrange", "host_dedup"}


@pytest.mark.parametrize("device_seeding", [False, True],
                         ids=["native", "device"])
def test_stage_totals(monkeypatch, capfd, device_seeding):
    """SEGALIGN_SYNC=1 and SEGALIGN_TIMING=1: every stage of the route is
    in STAGE_TOTALS, each chunk prints its stages, reset_stage_totals
    clears them, and the results do not change."""
    ref, query = dense_pair(np.random.default_rng(3))
    qrc = revcomp_codes(query)
    al = DeviceAligner(device="cpu", device_seeding=device_seeding,
                       **_kw(10**9))
    al.set_ref(ref)
    al.set_query(query, qrc)
    plain = al.seed_and_filter(0, 512, rev=False)
    monkeypatch.setenv("SEGALIGN_SYNC", "1")
    monkeypatch.setenv("SEGALIGN_TIMING", "1")
    devmod.reset_stage_totals()
    assert devmod.STAGE_TOTALS == {}
    capfd.readouterr()
    got = al.seed_and_filter(0, 512, rev=False)
    np.testing.assert_array_equal(got.hsps, plain.hsps)
    assert len(got.hsps) > 0
    want = DEVICE_STAGES if device_seeding else NATIVE_STAGES
    assert set(devmod.STAGE_TOTALS) == want
    assert all(v >= 0 for v in devmod.STAGE_TOTALS.values())
    if device_seeding:   # 1e-3 a hit range: a count
        n = devmod.STAGE_TOTALS["nrange"] * 1e3
        assert n >= 1 and n == pytest.approx(round(n))
    err = capfd.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("[timing] ")]
    assert lines, err
    named = set(re.findall(r"(\w+)=[\d.]+ms", " ".join(lines)))
    assert named == want
    devmod.reset_stage_totals()
    assert devmod.STAGE_TOTALS == {}


def _jax_result_keys():
    """The keys of the root bench.py's result line, read from its main."""
    tree = ast.parse(inspect.getsource(bench.main))
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "out" and \
                    isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and t.value.id == "out":
                keys.add(t.slice.value)
    return keys


def test_main_prints_the_jax_result_line(monkeypatch, capsys):
    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)
    for k in ("BENCH_REF_FASTA", "BENCH_QUERY_FASTA", "BENCH_VERIFY",
              "BENCH_STEADY", "BENCH_BREAKDOWN", "SEGALIGN_BENCH_GAPPED",
              "BENCH_SAVE_HSPS", "SEGALIGN_SYNC", "SEGALIGN_OVERLAP"):
        monkeypatch.delenv(k, raising=False)
    port_bench.main(["--device", "cpu"])
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[-1])
    want = _jax_result_keys()
    # BENCH_LEGACY=0 leaves out the legacy pass's key, in the JAX line too
    assert len(want) == 11 and set(out) == want - {"legacy_planted_mbps"}
    assert out["metric"] == "ungapped_query_mbps" and out["unit"] == "Mbp/s"
    assert out["engine_parity"].startswith("identical:row+roww256:")
    # both rounded to 3 places from the same unrounded value
    assert out["vs_baseline"] == pytest.approx(out["value"] / 2.0, abs=1e-3)
    assert set(out["densities"]) == {"1x"}
    assert out["breakdown"]["covered_frac"] >= 0.8
    assert set(out["breakdown"]["stages"]) == NATIVE_STAGES
    # the breakdown restored the switches it set
    assert "SEGALIGN_SYNC" not in os.environ
    assert "SEGALIGN_OVERLAP" not in os.environ
    # the JAX form of each pass's line, the same counts in each
    passes = re.findall(
        r"^bench\[(repeat-1x(?:-cold|-serial)?)\]: 0 Mbp query vs 0 Mbp ref "
        r"in [\d.]+s \(\+[\d.]+s table\) \| seeds=(\d+) hits=(\d+) "
        r"hsps=(\d+) \([\d.e+]+ hits/Mbp\) -> [\d.]+ Mbp/s$", cap.err,
        re.M)
    assert [p[0] for p in passes] == ["repeat-1x-cold", "repeat-1x",
                                      "repeat-1x-serial"]
    assert len({p[1:] for p in passes}) == 1
    n_hsps = int(passes[0][3])
    assert re.search(rf"^gapped stage \(native ydrop\): {n_hsps} segments "
                     rf"in [\d.]+s \(\d+ segments/s, {n_hsps} accepted\)",
                     cap.err, re.M)
    assert re.search(r"^e2e\[overlapped\+interference\]: ", cap.err, re.M)
    assert len(re.findall(r"^cell\[", cap.err, re.M)) == 5


def test_engine_parity_full_adds_the_device_route(monkeypatch):
    ref, query = bench_inputs.load_inputs(0.1, 0.06)
    pair = ref, query, revcomp_codes(query)
    monkeypatch.setenv("BENCH_VERIFY", "full")
    got = port_bench.engine_parity(*pair, "cpu")
    assert re.fullmatch(r"identical:row\+roww256\+device:[1-9]\d*hsps", got)
    monkeypatch.setenv("BENCH_VERIFY", "0")
    assert port_bench.engine_parity(*pair, "cpu") == \
        "skipped:BENCH_VERIFY=0"


def test_cuda_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port_bench.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
