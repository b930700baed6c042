"""The port's main path as genome-scale runs lay it out, held to the JAX
package on the CPU: the multi-record FASTA writer of the scale inputs
(bench_inputs.write_records_fasta) through both packages' readers and
arenas, the scale inputs' determinism, the pairwise CLI on a 0.4 x 0.4 Mbp
pair cut into 4 and 3 records on three routes and the RM CLI on a cut of
its reference, against the JAX CLIs (one JAX run of each, shared),
SEGALIGN_DEVICE_SEEDING read by the aligner wherever it is made, and the
candidate pack at block positions of 2^30 and beyond.

chip_smoke.py phase 3e runs the same CLIs at 8 and 16 Mbp on the card."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from segalign_tpu.io.blocks import build_arena as jax_build_arena  # noqa
from segalign_tpu.io.fasta import read_fasta as jax_read_fasta  # noqa: E402
from segalign_tpu_torch import bench as port_bench  # noqa: E402
from segalign_tpu_torch import bench_inputs  # noqa: E402
from segalign_tpu_torch.io.blocks import build_arena  # noqa: E402
from segalign_tpu_torch.io.fasta import read_fasta  # noqa: E402
from segalign_tpu_torch.parallel.multi import MultiDeviceAligner  # noqa
from segalign_tpu_torch.pipeline.device import _pack_compact  # noqa: E402

# sha256 of the (ref, query) FASTAs of write_scale_inputs(name) with both
# genomes drawn at 0.2 Mbp: each family's generator and record layout
SMALL_SHA256 = {
    # scale-4 is scale-8's layout, so the same bytes at 0.2 Mbp
    "scale-4": (
        "6d099788090ab353fba1d4fc49eca19ba96d91d6d7333cc6c84fb765d4771013",
        "b229cec4fe629fc3769dedc62583d26cfa32790ee1b8bdea151190d17dd0c41b"),
    "scale-8": (
        "6d099788090ab353fba1d4fc49eca19ba96d91d6d7333cc6c84fb765d4771013",
        "b229cec4fe629fc3769dedc62583d26cfa32790ee1b8bdea151190d17dd0c41b"),
    "scale-16": (
        "26413e5c11cf0cc7525c2007eb388a07ffd9b59621e81ad01de2a5666ad73561",
        "dfec2dcd27c97b0d972525f863ea65abff4ac0c8e00f77a872545286b1da7cbe"),
    "block-500": (
        "113353f20928269bf3d0a076f875d8bdb0c21e6b7080889916aa07487e4b027e",
        "e5ab85497d2a30434704e8a9e05800122aa88fd90482cfb124f23e4fb6d6beb2"),
}
# the CLI pair: the repeat-1x generator at 0.4 x 0.4 Mbp, the reference in
# 4 records and the query in 3, aligned without transitions; the repeat
# masker runs on the reference's first 50 kb, in 4 records. On the CPU the
# plain versions' continuation scans over long extensions cost minutes at
# more (the pair with transitions, the RM on 0.1 Mbp or more: 62-250 s)
PAIR_MBP = 0.4
RM_BASES = 50_000
PW_OPTS = ["--nogapped", "--markend", "--notransition"]
RM_OPTS = ["--markend"]


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---- the writer and the scale inputs

@pytest.mark.parametrize("block", [500_000_000, 500_000],
                         ids=["one-block", "two-blocks"])
def test_records_round_trip_through_both_packages(block, tmp_path):
    """Records cut from one code array come back from either package's
    read_fasta and build_arena with their names, lengths and codes
    (soft-masked code 4 and N included), and both arenas agree."""
    ref, _ = bench_inputs.load_inputs(1.2, 0.1)
    names, lengths = bench_inputs.record_layout("chr", 4, len(ref))
    path = str(tmp_path / "ref.fa")
    bench_inputs.write_records_fasta(path, ref, names, lengths)
    assert {4, 5} <= set(np.unique(ref).tolist())
    arenas = []
    for read, build in ((read_fasta, build_arena),
                        (jax_read_fasta, jax_build_arena)):
        recs = list(read(path))
        assert [r.name for r in recs] == names
        assert [len(r.seq) for r in recs] == lengths
        arena = build(read(path), block, with_rc=True)
        starts = np.cumsum([0] + lengths[:-1])
        for c, s, n in zip(arena.chroms, starts, lengths):
            np.testing.assert_array_equal(
                arena.codes[c.start:c.start + c.len], ref[s:s + n])
        arenas.append(arena)
    port, jax = arenas
    np.testing.assert_array_equal(port.codes, jax.codes)
    np.testing.assert_array_equal(port.rc_codes, jax.rc_codes)
    assert [(b.start, b.len, b.chroms) for b in port.blocks] == \
        [(b.start, b.len, b.chroms) for b in jax.blocks]
    assert len(port.blocks) == (1 if block > len(ref) else 2)


def test_records_writer_is_write_fasta(tmp_path):
    """The fast writer's bytes are write_fasta's for the same records, at
    lengths that end on, before and after a full line."""
    from segalign_tpu_torch.io.fasta import write_fasta
    codes = np.random.default_rng(3).integers(0, 6, 600).astype(np.uint8)
    lengths = [60, 59, 61, 1, 419]
    names = [f"r{i}" for i in range(len(lengths))]
    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    bench_inputs.write_records_fasta(a, codes, names, lengths)
    text = np.frombuffer(b"ACGTaNX&", np.uint8)[codes].tobytes()
    starts = np.cumsum([0] + lengths[:-1])
    write_fasta(b, [(n, text[s:s + ln])
                    for n, s, ln in zip(names, starts, lengths)])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(ValueError):
        bench_inputs.write_records_fasta(a, codes, names, lengths[:-1])


@pytest.mark.parametrize("name", sorted(bench_inputs.SCALE_INPUTS))
def test_scale_inputs_are_fixed(name, tmp_path, monkeypatch):
    """Each family's generator and record layout, drawn at 0.2 Mbp, writes
    fixed bytes with the family's record counts."""
    _, _, ref_rec, query_rec = bench_inputs.SCALE_INPUTS[name]
    monkeypatch.setitem(bench_inputs.SCALE_INPUTS, name,
                        (0.2, 0.2, ref_rec, query_rec))
    ref_fa, query_fa = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    bench_inputs.write_scale_inputs(name, ref_fa, query_fa)
    assert [len(list(read_fasta(f))) for f in (ref_fa, query_fa)] == \
        [ref_rec[1], query_rec[1]]
    assert (sha256(ref_fa), sha256(query_fa)) == SMALL_SHA256[name]


@pytest.mark.parametrize("name", ["scale-8", "scale-4"])
def test_scale_inputs_are_the_goldens_inputs(name, tmp_path):
    """scale-8's pair and scale-4's reference, at full size, are the
    FASTAs the JAX CLI goldens of chip_smoke.py phase 3e were computed
    on."""
    ref_fa, query_fa = str(tmp_path / "r.fa"), str(tmp_path / "q.fa")
    bench_inputs.write_scale_inputs(name, ref_fa, query_fa)
    if name == "scale-8":
        assert (sha256(ref_fa), sha256(query_fa)) == (
            chip_smoke.SCALE8_REF_SHA256, chip_smoke.SCALE8_QUERY_SHA256)
    else:
        assert sha256(ref_fa) == chip_smoke.SCALE4_REF_SHA256


# ---- both CLIs on a multi-record pair, against the JAX CLIs

# the CLI runs: label -> (module, input files (2: the pair, 3: the repeat
# masker's reference), options, env); the JAX CLIs' are the references,
# the port's run with --device cpu
CLI_RUNS = {
    "jax": ("segalign_tpu.cli.run_segalign", 2, PW_OPTS, {}),
    "native": ("segalign_tpu_torch.cli.run_segalign", 2, PW_OPTS, {}),
    "device": ("segalign_tpu_torch.cli.run_segalign", 2, PW_OPTS,
               {"SEGALIGN_DEVICE_SEEDING": "1"}),
    "sharded": ("segalign_tpu_torch.cli.run_segalign", 2,
                [*PW_OPTS, "--sharded_table", "--num_devices", "2"], {}),
    "jax rm": ("segalign_tpu.cli.run_segalign_repeat_masker", 3, RM_OPTS,
               {}),
    "rm": ("segalign_tpu_torch.cli.run_segalign_repeat_masker", 3, RM_OPTS,
           {}),
}


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """Every run of CLI_RUNS, all at once, each a process in a directory of
    its own: {label: output bytes}."""
    d = tmp_path_factory.mktemp("scale_pair")
    ref, query = bench_inputs.load_inputs(PAIR_MBP, PAIR_MBP)
    files = [str(d / f) for f in ("ref.fa", "query.fa", "rm.fa")]
    for path, codes, (prefix, n) in zip(
            files, (ref, query, ref[:RM_BASES]),
            (("chr", 4), ("q", 3), ("chr", 4))):
        bench_inputs.write_records_fasta(
            path, codes, *bench_inputs.record_layout(prefix, n, len(codes)))
    inputs = {2: files[:2], 3: files[2:]}
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("SEGALIGN_")}
    procs = {}
    try:
        for label, (module, n_in, opts, env) in CLI_RUNS.items():
            cwd = d / label.replace(" ", "_")
            cwd.mkdir()
            argv = [*inputs[n_in], *opts, "--output", str(cwd / "out")]
            if not module.startswith("segalign_tpu."):
                argv += ["--device", "cpu"]
            procs[label] = subprocess.Popen(
                [sys.executable, "-m", module, *argv], cwd=cwd,
                env=dict(base, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                         OMP_NUM_THREADS="2", **env),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        outs = {}
        for label, p in procs.items():
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, (label, err.decode()[-2000:])
            with open(d / label.replace(" ", "_") / "out", "rb") as f:
                outs[label] = f.read()
        return outs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("route", ["native", "device", "sharded"])
def test_pairwise_cli_matches_jax(route, cli_outputs):
    want = cli_outputs["jax"]
    assert cli_outputs[route] == want
    lines = want.decode().splitlines()
    assert lines[-1] == "# segalign end-of-file"
    # HSPs on every query record, named as records
    assert {ln.split("\t")[3] for ln in lines[:-1]} == {"q1", "q2", "q3"}


def test_rm_cli_matches_jax(cli_outputs):
    assert cli_outputs["rm"] == cli_outputs["jax rm"]
    assert cli_outputs["jax rm"].count(b"\n") > 2


# ---- SEGALIGN_DEVICE_SEEDING, read by the aligner

def _farm(**kw):
    return MultiDeviceAligner(
        device="cpu", num_devices=2,
        **{k: v for k, v in bench_inputs.aligner_settings("cpu").items()
           if k != "device"}, **kw)


@pytest.mark.parametrize("value,route", [("1", True), ("", False),
                                         ("0", False)],
                         ids=["set", "empty", "zero"])
def test_aligners_read_device_seeding(value, route, monkeypatch):
    """The bench's aligner and every aligner of the farm take the route
    from the variable, read when each is made, as the JAX aligner does."""
    monkeypatch.setenv("SEGALIGN_DEVICE_SEEDING", value)
    assert port_bench.make_aligner("cpu").device_seeding is route
    assert [a.device_seeding for a in _farm().aligners] == [route, route]
    monkeypatch.delenv("SEGALIGN_DEVICE_SEEDING")
    assert port_bench.make_aligner("cpu").device_seeding is False


@pytest.mark.parametrize("explicit", [True, False])
def test_explicit_route_wins_over_the_variable(explicit, monkeypatch):
    monkeypatch.setenv("SEGALIGN_DEVICE_SEEDING", "0" if explicit else "1")
    assert port_bench.make_aligner(
        "cpu", device_seeding=explicit).device_seeding is explicit
    assert [a.device_seeding for a in _farm(
        device_seeding=explicit).aligners] == [explicit, explicit]


# ---- the candidate pack past 2^30

def _plain_pack(cand, rs, qs, ln, seg):
    """The first candidate, in hit order, of every (batch, rs, qs, length)."""
    seen, keep = set(), []
    for i in range(len(cand)):
        key = (seg[i], rs[i], qs[i], ln[i])
        if cand[i] and key not in seen:
            seen.add(key)
            keep.append(i)
    return np.array(keep, np.int64)


@pytest.mark.parametrize("base", [0, (1 << 30) - 50, (1 << 31) - 400],
                         ids=["low", "across-2^30", "near-2^31"])
def test_pack_keeps_candidates_at_every_block_position(base):
    """Exact duplicates within a logical batch go and every other
    candidate stays, in hit order, at reference positions below, across
    and far past 2^30 (the repeat masker's block of a genome over 1.1
    Gbp); the JAX key dropped every candidate at rs >= 2^30."""
    rng = np.random.default_rng(11)
    # 150 distinct extents, each drawn several times over 600 hits
    k, n = 150, 600
    ext = rng.integers(0, k, n)
    rs = base + rng.permutation(300)[:k][ext]
    qs = rng.integers(0, 50, k)[ext]
    ln = rng.integers(1, 40, k)[ext]
    cand = rng.random(n) < 0.7
    seg_ends = np.array([200, 400], np.int64)
    fins = []
    for part in np.array_split(np.arange(n), 3):
        t = lambda a: torch.from_numpy(a[part].astype(np.int32))
        fins.append(dict(candidate=torch.from_numpy(cand[part]),
                         orig=torch.from_numpy(part), rs=t(rs), qs=t(qs),
                         length=t(ln), total=t(qs + 7),
                         counts=torch.from_numpy(np.stack(
                             [ln[part]] * 4, 1).astype(np.int32))))
    out = _pack_compact(fins, torch.from_numpy(seg_ends)).numpy()
    seg = np.searchsorted(seg_ends, np.arange(n), side="right")
    want = _plain_pack(cand, rs, qs, ln, seg)
    np.testing.assert_array_equal(out[:, 0], want)
    np.testing.assert_array_equal(out[:, 1], rs[want])
    np.testing.assert_array_equal(out[:, 2], qs[want])
    np.testing.assert_array_equal(out[:, 3], ln[want])
    np.testing.assert_array_equal(out[:, 5:], np.stack([ln[want]] * 4, 1))
    assert (out[:, 1] >= base).all() and 150 < len(want) < cand.sum()


# ---- the per-chunk hit ceiling on every route

def test_chunk_seeds_counts_hits_past_the_int32_cumsum():
    """Four seeds of 2^31 - 1 hits each: the int32 cumsum wraps (as the
    JAX package's does), the hit count in stats does not."""
    from segalign_tpu_torch.ops.seeding import chunk_seeds
    index_table = torch.zeros(16, dtype=torch.int32)
    index_table[15] = (1 << 31) - 1          # every hit in bucket TT
    query_pad = torch.full((8 + 4 + 2,), 3, dtype=torch.uint8)
    _, _, _, _, cum, stats = chunk_seeds(
        query_pad, index_table, 0, 4, CHUNK=4, seed_size=2,
        shape_pos=(0, 1), transition=False, pad=8)
    assert stats.tolist() == [4, 4 * ((1 << 31) - 1)]
    assert cum.dtype == torch.int32 and int(cum[-1]) != stats[1]


@pytest.mark.parametrize("route", ["native", "device", "sharded"])
def test_every_route_stops_at_the_chunk_hit_ceiling(route, monkeypatch):
    """SEGALIGN_MAX_CHUNK_HITS stops a chunk-strand on every route; the
    device routes ran past it before."""
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 60_000).astype(np.uint8)
    query = rng.integers(0, 4, 20_000).astype(np.uint8)
    kw = dict(bench_inputs.aligner_settings("cpu"), chunk_size=10_000)
    if route == "sharded":
        al = ShardedAligner(num_devices=2, **kw)
    else:
        al = DeviceAligner(device_seeding=route == "device", **kw)
    al.set_ref(ref)
    al.set_query(query, query[::-1].copy())
    assert al.seed_and_filter(0, 10_000, False).num_hits > 100
    monkeypatch.setenv("SEGALIGN_MAX_CHUNK_HITS", "100")
    with pytest.raises(RuntimeError, match=r"seed hits \(> 100\)"):
        al.seed_and_filter(0, 10_000, False)
