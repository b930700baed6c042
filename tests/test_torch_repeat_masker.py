"""The port's repeat masker against the JAX package's, on both of the
port's seeding routes.

The aligner in rm_mode with a reference window (per chunk-strand HSPs),
run_repeat_masker (the interval files) and the CLI (its output, byte for
byte) against the JAX package on the CPU; and the three host functions the
port copies against their originals."""

import dataclasses
import os

import numpy as np
import pytest

from segalign_tpu.config import (RMConfig, build_substitution_matrix,
                                 make_seed_config)
from segalign_tpu.io.blocks import chunk_interval
from segalign_tpu.io.fasta import write_fasta
from segalign_tpu.pipeline import repeat_masker as jrm
from segalign_tpu.pipeline.device import DeviceAligner as JaxAligner
from segalign_tpu_torch.pipeline import repeat_masker as prm
from segalign_tpu_torch.pipeline.device import DeviceAligner

RC = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)
ROUTES = {"native": False, "device": True}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rm_aligner_matches_jax(route):
    """The sequence and window of tests/test_device_vs_oracle.py's RM case:
    a self-alignment with an internal repeat, hits restricted to the
    window, minus-strand HSPs remapped, dedup_rm."""
    rng = np.random.default_rng(7)
    sc = make_seed_config("12of19")
    seq = rng.integers(0, 4, 1500).astype(np.uint8)
    core = rng.integers(0, 4, 300).astype(np.uint8)
    seq[100:400] = core
    seq[800:1100] = core
    rc = RC[seq[::-1]]
    kw = dict(shape_pos=sc.shape_pos, seed_size=sc.size,
              transition=sc.transition, step=1,
              sub_mat=build_substitution_matrix(910), xdrop=910,
              hspthresh=1500, noentropy=False, chunk_size=512,
              max_hits=10**9, HBUF=256, rm_mode=True)
    jax_al = JaxAligner(B=256, W=128, **kw)
    port = DeviceAligner(device="cpu", device_seeding=ROUTES[route], **kw)
    for al in (jax_al, port):
        al.set_ref(seq)
        al.set_query(seq, rc)
    window = (200, 1200)
    total = 0
    for (cs, ce) in chunk_interval(0, len(seq) - sc.size, 512):
        for rev in (False, True):
            want = jax_al.seed_and_filter(cs, ce, rev, window=window)
            got = port.seed_and_filter(cs, ce, rev, window=window)
            assert (got.num_hits, got.num_seeds) == (want.num_hits,
                                                     want.num_seeds)
            np.testing.assert_array_equal(got.hsps, want.hsps,
                                          err_msg=f"{cs}:{ce} rev={rev}")
            total += len(got.hsps)
    assert total > 0


def _rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def rm_genome(tmp_path_factory):
    """The genome of tests/test_e2e_rm.py: one repeat, three copies over
    two chromosomes."""
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("rm")
    rep = _rand_dna(rng, 250)
    chr1 = (_rand_dna(rng, 300) + rep + _rand_dna(rng, 200) + rep +
            _rand_dna(rng, 300))
    chr2 = _rand_dna(rng, 250) + rep + _rand_dna(rng, 350)
    path = str(d / "seq.fa")
    write_fasta(path, [("chr1", chr1), ("chr2", chr2)])
    return path


def _cfg(path):
    return RMConfig(seq_filename=path, hspthresh=1500, noentropy=True,
                    wga_chunk_size=512, lastz_interval_size=700,
                    seq_block_size=1400)


def _interval_files(out_dir):
    out = {}
    for f in sorted(os.listdir(out_dir)):
        if f != "MANIFEST.jsonl":
            with open(os.path.join(out_dir, f)) as fh:
                out[f] = fh.read()
    return out


@pytest.fixture(scope="module")
def jax_intervals(rm_genome, tmp_path_factory):
    cfg = _cfg(rm_genome)
    out_dir = str(tmp_path_factory.mktemp("jax_rm"))
    al = JaxAligner(
        shape_pos=cfg.seed.shape_pos, seed_size=cfg.seed.size,
        transition=cfg.seed.transition, step=cfg.step, sub_mat=cfg.sub_mat,
        xdrop=cfg.xdrop, hspthresh=cfg.hspthresh, noentropy=cfg.noentropy,
        chunk_size=cfg.wga_chunk_size, HBUF=1024, B=256, rm_mode=True)
    jrm.run_repeat_masker(cfg, out_dir, aligner=al)
    files = _interval_files(out_dir)
    assert len(files) > 1   # several intervals with runs
    return files


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_run_repeat_masker_matches_jax(route, rm_genome, jax_intervals,
                                       tmp_path):
    stats = prm.run_repeat_masker(_cfg(rm_genome), str(tmp_path),
                                  device="cpu",
                                  device_seeding=ROUTES[route])
    assert _interval_files(str(tmp_path)) == jax_intervals
    assert stats.num_hsps > 0 and stats.intervals_done > 2


CLI_OPTS = ["--markend", "--noentropy", "--hspthresh", "1500",
            "--wga_chunk_size", "512", "--lastz_interval_size", "700",
            "--seq_block_size", "1400"]


@pytest.fixture(scope="module")
def jax_cli_output(rm_genome, tmp_path_factory):
    from segalign_tpu.cli.run_segalign_repeat_masker import main
    d = tmp_path_factory.mktemp("jax_cli")
    out = str(d / "seq.seg")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert main([rm_genome, "--output", out, *CLI_OPTS]) == 0
    finally:
        os.chdir(cwd)
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rm_cli_identical_to_jax(route, rm_genome, jax_cli_output, tmp_path,
                                 monkeypatch):
    from segalign_tpu_torch.cli.run_segalign_repeat_masker import main
    monkeypatch.chdir(tmp_path)
    if ROUTES[route]:
        monkeypatch.setenv("SEGALIGN_DEVICE_SEEDING", "1")
    out = str(tmp_path / "seq.seg")
    assert main([rm_genome, "--output", out, *CLI_OPTS,
                 "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        data = f.read()
    assert data == jax_cli_output
    lines = data.decode().splitlines()
    assert lines[-1] == "# segalign_repeat_masker end-of-file"
    assert len([ln for ln in lines if not ln.startswith("#")]) > 2
    assert not [d for d in os.listdir(tmp_path) if d.startswith("output_")]


def test_rm_cli_without_cuda_raises(rm_genome, monkeypatch):
    import torch
    from segalign_tpu_torch.cli.run_segalign_repeat_masker import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([rm_genome])


def test_sharded_table_matches_jax(rm_genome, jax_intervals, tmp_path):
    """cfg.sharded_table selects the sharded aligner (two shards on the
    CPU); tests/test_torch_sharded.py holds it to the replicated one."""
    cfg = _cfg(rm_genome)
    cfg.sharded_table, cfg.num_devices = True, 2
    stats = prm.run_repeat_masker(cfg, str(tmp_path), device="cpu")
    assert _interval_files(str(tmp_path)) == jax_intervals
    assert stats.num_hsps > 0


def test_load_rm_arena_copy_matches(rm_genome):
    got_codes, got_chroms = prm.load_rm_arena(rm_genome)
    want_codes, want_chroms = jrm.load_rm_arena(rm_genome)
    np.testing.assert_array_equal(got_codes, want_codes)
    # the two packages each have a Chrom class: compare the fields
    assert ([dataclasses.astuple(c) for c in got_chroms]
            == [dataclasses.astuple(c) for c in want_chroms])


def test_plan_rm_blocks_copy_matches():
    rng = np.random.default_rng(17)
    for _ in range(40):
        kw = dict(lastz_interval_size=int(rng.integers(100, 3000)),
                  seq_block_size=int(rng.integers(500, 20_000)),
                  neighbor_proportion=float(rng.choice([0.0, 0.2, 0.5, 1])))
        cfg = RMConfig(**kw)
        n = int(rng.integers(1, 60_000))
        got, want = prm.plan_rm_blocks(n, cfg), jrm.plan_rm_blocks(n, cfg)
        assert [vars(b) | {"intervals": [vars(i) for i in b.intervals]}
                for b in got] == \
            [vars(b) | {"intervals": [vars(i) for i in b.intervals]}
             for b in want], (n, kw)


def test_coverage_runs_sparse_copy_matches():
    """Random HSP sets with uint8 wrap and runs at the block end."""
    rng = np.random.default_rng(23)
    for trial in range(40):
        block_len = int(rng.integers(50, 3000))
        n = int(rng.integers(0, 400))
        qs = rng.integers(0, block_len, n).astype(np.int64)
        ends = np.minimum(qs + rng.integers(1, 50, n), block_len)
        if trial % 4 == 0:
            qs = np.concatenate([qs, np.full(300, 5, np.int64)])
            ends = np.concatenate([ends, np.full(300, 15, np.int64)])
        if trial % 5 == 0:
            qs = np.concatenate([qs, [block_len - 8]])
            ends = np.concatenate([ends, [block_len]])
        M = int(rng.integers(1, 4))
        assert prm.coverage_runs_sparse(qs, ends, block_len, M) == \
            jrm.coverage_runs_sparse(qs, ends, block_len, M), trial
