"""The port's per-chunk aligner and CLI against the JAX package's.

Both run on the CPU here; the HSPs of every chunk-strand and the segments
files of a --nogapped CLI run must be identical."""

import os

import numpy as np
import pytest

from segalign_tpu.config import make_seed_config, build_substitution_matrix
from segalign_tpu.io.blocks import chunk_interval
from segalign_tpu.io.fasta import write_fasta
from segalign_tpu.pipeline.device import DeviceAligner as JaxAligner
from segalign_tpu_torch.parallel.multi import ChunkWork, MultiDeviceAligner
from segalign_tpu_torch.pipeline.device import DeviceAligner

RC = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)
SC = make_seed_config("12of19")
SUB = build_substitution_matrix(910)


def make_pair(rng, n_ref=2200, n_query=2600):
    """The pair of tests/test_device_vs_oracle.py: an exact and a diverged
    shared core, a soft-masked stretch and Ns."""
    ref = rng.integers(0, 4, n_ref).astype(np.uint8)
    query = rng.integers(0, 4, n_query).astype(np.uint8)
    core = rng.integers(0, 4, 400).astype(np.uint8)
    ref[300:700] = core
    query[500:900] = core
    mut = rng.random(400) < 0.05
    core2 = np.where(mut, (core + 1) % 4, core).astype(np.uint8)
    ref[1200:1600] = core2
    query[1500:1900] = core
    ref[1000:1020] = 4
    query[100:110] = 5
    return ref, query


def dense_pair(rng, n=4000):
    """The pair of tests/test_pipelined_dispatch.py: a long exact repeat,
    so that nearly every hit is a candidate."""
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, 1200).astype(np.uint8)
    ref[200:1400] = core
    query[300:1500] = core
    return ref, query


def _kw(max_hits, hspthresh=1500):
    return dict(shape_pos=SC.shape_pos, seed_size=SC.size,
                transition=SC.transition, step=1, sub_mat=SUB, xdrop=910,
                hspthresh=hspthresh, noentropy=False, chunk_size=512,
                max_hits=max_hits)


@pytest.mark.parametrize("max_hits", [10**9, 64])
def test_aligner_matches_jax(max_hits):
    ref, query = make_pair(np.random.default_rng(42))
    qrc = RC[query[::-1]]
    jax_al = JaxAligner(HBUF=1024, B=256, W=128, **_kw(max_hits))
    port = DeviceAligner(device="cpu", HBUF=1024, **_kw(max_hits))
    for al in (jax_al, port):
        al.set_ref(ref)
        al.set_query(query, qrc)
    total = 0
    for (cs, ce) in chunk_interval(0, len(query) - SC.size, 512):
        for rev in (False, True):
            want = jax_al.seed_and_filter(cs, ce, rev)
            got = port.seed_and_filter(cs, ce, rev)
            assert (got.num_hits, got.num_seeds) == (want.num_hits,
                                                     want.num_seeds)
            np.testing.assert_array_equal(got.hsps, want.hsps,
                                          err_msg=f"{cs}:{ce} rev={rev}")
            total += len(got.hsps)
    assert total > 0


def test_pipelined_map_chunks_matches_sequential():
    ref, query = dense_pair(np.random.default_rng(12))
    qrc = RC[query[::-1]]
    work = [ChunkWork(cs, ce, rev)
            for (cs, ce) in chunk_interval(0, len(query) - SC.size, 512)
            for rev in (False, True)]
    # programs of 512 rows: a dense chunk-strand spans several
    multi = MultiDeviceAligner(device="cpu", HBUF=512, **_kw(10**9))
    multi.set_ref(ref)
    multi.set_query(query, qrc)
    (al,) = multi.aligners
    seq = [al.seed_and_filter(w.chunk_start, w.chunk_end, w.rev)
           for w in work]
    seen = []
    piped = multi.map_chunks(work, depth=3)
    piped_cb = al.map_chunks(work, depth=2,
                             on_result=lambda i, r: seen.append(i))
    assert seen == list(range(len(work)))
    nonzero = 0
    for a, b, c in zip(seq, piped, piped_cb):
        for r in (b, c):
            assert (r.num_hits, r.num_seeds) == (a.num_hits, a.num_seeds)
            np.testing.assert_array_equal(r.hsps, a.hsps)
        nonzero += len(a.hsps)
    assert nonzero > 0


def test_more_devices_than_the_machine_has_raises(monkeypatch):
    """--device cuda --num_devices 2 names cuda:0 and cuda:1; on the CPU,
    or on one card, two aligners are asked for with --device cpu or
    cuda:0."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="this machine has 1"):
        MultiDeviceAligner(device="cuda", num_devices=2, **_kw(10**9))
    assert MultiDeviceAligner(device="cpu", num_devices=2,
                              **_kw(10**9)).num_devices == 2


def _rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """The genomes of tests/test_e2e_pairwise.py."""
    rng = np.random.default_rng(123)
    d = tmp_path_factory.mktemp("genomes")
    core1 = _rand_dna(rng, 500)
    core2 = _rand_dna(rng, 400)
    t_chr1 = _rand_dna(rng, 700) + core1 + _rand_dna(rng, 500)
    t_chr2 = _rand_dna(rng, 300) + core2 + _rand_dna(rng, 800)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc_core2 = "".join(comp[c] for c in reversed(core2))
    q_chr1 = _rand_dna(rng, 400) + core1 + _rand_dna(rng, 300)
    q_chr2 = _rand_dna(rng, 600) + rc_core2 + _rand_dna(rng, 200)
    q_chr3 = _rand_dna(rng, 900)
    ref_fa, query_fa = str(d / "target.fa"), str(d / "query.fa")
    write_fasta(ref_fa, [("t_chr1", t_chr1), ("t_chr2", t_chr2)])
    write_fasta(query_fa, [("q_chr1", q_chr1), ("q_chr2", q_chr2),
                           ("q_chr3", q_chr3)])
    return ref_fa, query_fa


def test_cli_segments_identical_to_jax(genomes, tmp_path, monkeypatch):
    from segalign_tpu.cli.run_segalign import main as jax_main
    from segalign_tpu_torch.cli.run_segalign import main as port_main
    monkeypatch.chdir(tmp_path)
    opts = ["--nogapped", "--markend", "--noentropy", "--hspthresh", "1500",
            "--wga_chunk_size", "512", "--lastz_interval_size", "1000",
            "--seq_block_size", "1500"]
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.segments")
        assert main([*genomes, "--output", out, *opts, *extra]) == 0
        with open(out, "rb") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"]
    lines = outs["port"].decode().splitlines()
    assert lines[-1] == "# segalign end-of-file" and len(lines) > 2
    assert {ln.split("\t")[6] for ln in lines[:-1]} == {"+", "-"}
    assert not [d for d in os.listdir(tmp_path) if d.startswith("output_")]


def test_cli_without_cuda_raises(genomes, monkeypatch):
    import torch
    from segalign_tpu_torch.cli.run_segalign import main as port_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main([*genomes, "--nogapped"])
