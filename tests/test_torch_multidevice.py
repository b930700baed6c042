"""The port's chunk farm against the JAX package on the same inputs.

Four aligners on the CPU give, array for array, what the JAX package's
aligner gives chunk-strand by chunk-strand, on both seeding routes and in
rm_mode with a window (the inputs of tests/test_multidevice.py), and what
one aligner of the port gives; a failing worker loses no chunk and keeps
the work order; both CLIs with --num_devices 2 write the bytes of the JAX
CLI. JAX_SHA256 holds the digests of the JAX results, so that a test on a
machine without JAX (tests/test_torch_cuda.py) can hold the farm to them."""

import functools
import hashlib
import os
import threading

import numpy as np
import pytest

from segalign_tpu.config import build_substitution_matrix, make_seed_config
from segalign_tpu.io.fasta import write_fasta
from segalign_tpu_torch.parallel.multi import (ChunkWork, MultiDeviceAligner,
                                               resolve_devices)

RC = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)
SC = make_seed_config("12of19")
N = 4000


def inputs(rm=False):
    """(ref, query, its reverse complement, the RM window or None)."""
    if rm:
        # the self-alignment of tests/test_torch_repeat_masker.py, longer
        rng = np.random.default_rng(7)
        seq = rng.integers(0, 4, N).astype(np.uint8)
        seq[2800:3100] = seq[100:400]
        return seq, seq, RC[seq[::-1]], (200, 3500)
    rng = np.random.default_rng(77)
    ref = rng.integers(0, 4, N).astype(np.uint8)
    query = rng.integers(0, 4, N).astype(np.uint8)
    core = rng.integers(0, 4, 600).astype(np.uint8)
    ref[500:1100] = core
    query[2000:2600] = core
    return ref, query, RC[query[::-1]], None


def settings(**extra):
    return dict(shape_pos=SC.shape_pos, seed_size=SC.size, transition=True,
                step=1, sub_mat=build_substitution_matrix(910), xdrop=910,
                hspthresh=1500, noentropy=False, chunk_size=512, HBUF=1024,
                **extra)


def chunk_work(window=None):
    q_len = N - SC.size
    return [ChunkWork(cs, min(cs + 512, q_len), rev, window)
            for cs in range(0, q_len, 512) for rev in (False, True)]


def digest(results):
    """sha256 over every chunk-strand's num_hits, num_seeds and HSPs."""
    h = hashlib.sha256()
    for r in results:
        h.update(np.array([r.num_hits, r.num_seeds], np.int64).tobytes())
        h.update(np.ascontiguousarray(r.hsps, np.int64).tobytes())
    return h.hexdigest()


# digest(jax_results(rm)), checked by test_jax_digests
JAX_SHA256 = {
    False: "fdc80d98ca96578d85579a8c086c7eb7a4ea369c9f149ced9992f43d8f9e4157",
    True: "66d10f96d4d75a19ba624f56f485b9361ff3e42c90f6df40d967a57d78a00413"}


@functools.lru_cache(maxsize=None)
def jax_results(rm=False):
    """What the JAX package's aligner gives for inputs(rm), chunk-strand
    by chunk-strand in the order of chunk_work."""
    from segalign_tpu.pipeline.device import DeviceAligner as JaxAligner
    ref, query, qrc, window = inputs(rm)
    al = JaxAligner(B=256, W=128, rm_mode=rm, **settings())
    al.set_ref(ref)
    al.set_query(query, qrc)
    return [al.seed_and_filter(w.chunk_start, w.chunk_end, w.rev,
                               window=w.window) for w in chunk_work(window)]


def _loaded(num_devices, rm=False, **extra):
    ref, query, qrc, _ = inputs(rm)
    al = MultiDeviceAligner(num_devices=num_devices, device="cpu",
                            rm_mode=rm, **settings(**extra))
    al.set_ref(ref)
    al.set_query(query, qrc)
    return al


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.num_hits, a.num_seeds) == (b.num_hits, b.num_seeds)
        np.testing.assert_array_equal(a.hsps, b.hsps)
    assert sum(len(r.hsps) for r in want) > 0


@pytest.mark.parametrize("rm", [False, True], ids=["pairwise", "rm"])
def test_jax_digests(rm):
    assert digest(jax_results(rm)) == JAX_SHA256[rm]


@pytest.mark.parametrize("rm", [False, True], ids=["pairwise", "rm"])
@pytest.mark.parametrize("device_seeding", [False, True],
                         ids=["native", "device"])
def test_four_aligners_match_one(device_seeding, rm):
    single = _loaded(1, rm, device_seeding=device_seeding)
    multi = _loaded(4, rm, device_seeding=device_seeding)
    assert (single.num_devices, multi.num_devices) == (1, 4)
    work = chunk_work(inputs(rm)[3])
    got = multi.map_chunks(work)
    assert_same(got, jax_results(rm))
    assert_same(got, single.map_chunks(work))
    assert not multi.errors and not multi.dead
    assert sum(multi.chunks_by) == len(work)


@pytest.mark.parametrize("device_seeding", [False, True],
                         ids=["native", "device"])
def test_failing_worker_loses_no_chunk(device_seeding, capfd):
    work = chunk_work()
    multi = _loaded(3, device_seeding=device_seeding)
    entry = "seed_and_filter" if device_seeding else "dispatch_chunk"
    failed = threading.Event()
    calls = []

    def flaky(orig):
        def call(*a, **k):
            calls.append(a)
            if len(calls) == 2:
                failed.set()
                raise RuntimeError("injected device failure")
            return orig(*a, **k)
        return call

    def held(orig):
        # the other workers start once the flaky one has failed, so the
        # failure does not depend on which thread the queue serves first
        def call(*a, **k):
            assert failed.wait(60)
            return orig(*a, **k)
        return call

    for i, al in enumerate(multi.aligners):
        wrap = flaky if i == 1 else held
        setattr(al, entry, wrap(getattr(al, entry)))
    got = multi.map_chunks(work, depth=2)
    assert len(calls) == 2
    assert_same(got, jax_results())
    # the failure the requeue absorbed stays on the farm, and on stderr
    assert [str(e) for e in multi.errors] == ["injected device failure"]
    assert multi.dead == {1} and sum(multi.chunks_by) == len(work)
    assert "aligner 1 on cpu failed" in capfd.readouterr().err


def test_more_workers_than_cores_under_a_short_switch_interval():
    """Sixteen workers and their finishers over a short queue, threads
    switched every few microseconds: every chunk is done once and lands in
    its place."""
    import sys
    work = chunk_work() * 3
    want = jax_results() * 3
    multi = _loaded(16)
    done = []
    for al in multi.aligners:
        def counted(p, orig=al.finish_chunk):
            done.append((p.chunk_start, p.rev))
            return orig(p)
        al.finish_chunk = counted
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = multi.map_chunks(work, depth=1)
    finally:
        sys.setswitchinterval(was)
    assert_same(got, want)
    assert sorted(done) == sorted((w.chunk_start, w.rev) for w in work)


def test_every_aligner_failing_raises_the_first_error():
    multi = _loaded(2)

    def boom(*a, **k):
        raise RuntimeError("no device left")

    for al in multi.aligners:
        al.dispatch_chunk = boom
    with pytest.raises(RuntimeError, match="no device left"):
        multi.map_chunks(chunk_work())
    assert multi.dead == {0, 1} and len(multi.errors) == 2


def test_straggler_pass_runs_on_a_survivor(capfd):
    """A worker that fails after the other has drained the queue and left:
    its chunk is finished by the pass after the join."""
    work = chunk_work()
    multi = _loaded(2)
    bad, good = multi.aligners
    taken, good_thread = threading.Event(), []
    orig = good.dispatch_chunk

    def late(*a, **k):
        taken.set()
        while not good_thread:
            threading.Event().wait(0.01)
        good_thread[0].join(60)
        raise RuntimeError("injected device failure")

    def after_the_bad_one(*a, **k):
        assert taken.wait(60)
        good_thread[:] = [threading.current_thread()]
        return orig(*a, **k)

    bad.dispatch_chunk, good.dispatch_chunk = late, after_the_bad_one
    assert_same(multi.map_chunks(work), jax_results())
    assert "retrying 1 chunk(s) after device failure" in \
        capfd.readouterr().err


def test_devices_of_a_request(monkeypatch):
    import torch
    cpu = torch.device("cpu")
    assert resolve_devices("cpu", -1) == [cpu]
    assert resolve_devices("cpu", 3) == [cpu] * 3
    assert resolve_devices("cuda:1", 2) == [torch.device("cuda", 1)] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_devices("cuda", -1) == [torch.device("cuda", i)
                                           for i in range(4)]
    assert resolve_devices("cuda", 2) == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="this machine has 4"):
        resolve_devices("cuda", 5)


def _rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """A pair with homologies on both strands, and a genome with a repeat
    in three copies (the shapes of tests/test_torch_pipeline.py and
    tests/test_torch_repeat_masker.py)."""
    rng = np.random.default_rng(31)
    d = tmp_path_factory.mktemp("farm_cli")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    core1, core2 = _rand_dna(rng, 500), _rand_dna(rng, 400)
    rc2 = "".join(comp[c] for c in reversed(core2))
    paths = {k: str(d / f"{k}.fa") for k in ("ref", "query", "seq")}
    write_fasta(paths["ref"], [
        ("t1", _rand_dna(rng, 700) + core1 + _rand_dna(rng, 500)),
        ("t2", _rand_dna(rng, 300) + core2 + _rand_dna(rng, 800))])
    write_fasta(paths["query"], [
        ("q1", _rand_dna(rng, 400) + core1 + _rand_dna(rng, 300)),
        ("q2", _rand_dna(rng, 600) + rc2 + _rand_dna(rng, 200))])
    rep = _rand_dna(rng, 250)
    write_fasta(paths["seq"], [
        ("chr1", _rand_dna(rng, 300) + rep + _rand_dna(rng, 200) + rep
         + _rand_dna(rng, 300)),
        ("chr2", _rand_dna(rng, 250) + rep + _rand_dna(rng, 350))])
    return paths


OPTS = ["--markend", "--noentropy", "--hspthresh", "1500",
        "--wga_chunk_size", "512"]


@pytest.mark.parametrize("cli", ["pairwise", "rm"])
def test_cli_two_devices_identical_to_one(cli, fastas, tmp_path,
                                          monkeypatch):
    """The JAX CLI on one device, then the port's on one and on two."""
    if cli == "pairwise":
        from segalign_tpu.cli.run_segalign import main as jax_main
        from segalign_tpu_torch.cli.run_segalign import main
        argv = [fastas["ref"], fastas["query"], "--nogapped",
                "--lastz_interval_size", "1000", "--seq_block_size", "1500"]
    else:
        from segalign_tpu.cli.run_segalign_repeat_masker import \
            main as jax_main
        from segalign_tpu_torch.cli.run_segalign_repeat_masker import main
        argv = [fastas["seq"], "--lastz_interval_size", "700",
                "--seq_block_size", "1400"]
    monkeypatch.chdir(tmp_path)
    outs = []
    for name, run, extra in (("jax", jax_main, []),
                             ("one", main, ["--device", "cpu"]),
                             ("two", main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        assert run([*argv, *OPTS, *extra, "--output", out, "--num_devices",
                    "2" if name == "two" else "1"]) == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] == outs[2]
    assert outs[0].count(b"\n") > 3
    assert not [d for d in os.listdir(tmp_path) if d.startswith("output_")]
