"""The port's sharded seed table against the JAX package on the same
inputs: shard_seed_table against the JAX one, ShardedAligner chunk-strand
by chunk-strand against the JAX package's aligner (which
tests/test_sharded_table.py holds the JAX sharded program to) and against
the port's replicated DeviceAligner, and both CLIs with --sharded_table
against the JAX CLIs, byte for byte.

JAX_SHA256 holds the digests of the JAX results, so that a test on a
machine without JAX (tests/test_torch_cuda.py) can hold the shards to
them. The JAX sharded program's fixed capacities and their overflow flag
have no counterpart in the port (tensors are sized by the data), so
tests/test_sharded_table.py::test_sharded_overflow_detected has none
here."""

import functools
import os

import numpy as np
import pytest
import torch

from segalign_tpu.config import build_substitution_matrix, make_seed_config
from segalign_tpu.index.seed_table import build_seed_table
from segalign_tpu.io.blocks import chunk_interval
from segalign_tpu.io.fasta import write_fasta
from segalign_tpu_torch.parallel.multi import ChunkWork
from segalign_tpu_torch.parallel.sharded import (ShardedAligner, exchange,
                                                 shard_devices,
                                                 shard_seed_table)
from segalign_tpu_torch.pipeline.device import DeviceAligner
from test_torch_multidevice import assert_same, digest

RC = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)
SC = make_seed_config("12of19")
N = 4000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """torch's ops on at most four threads: these tensors are a few
    thousand elements, and a larger pool per op only waits on its own
    threads when the CPU is shared."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


def _rm_seq():
    """The self-alignment of tests/test_torch_repeat_masker.py."""
    rng = np.random.default_rng(7)
    seq = rng.integers(0, 4, 1500).astype(np.uint8)
    core = rng.integers(0, 4, 300).astype(np.uint8)
    seq[100:400] = core
    seq[800:1100] = core
    return seq


def _pair():
    """The pair of tests/test_sharded_table.py."""
    rng = np.random.default_rng(17)
    ref = rng.integers(0, 4, N).astype(np.uint8)
    query = rng.integers(0, 4, N).astype(np.uint8)
    core = rng.integers(0, 4, 700).astype(np.uint8)
    ref[500:1200] = core
    query[900:1600] = core
    mut = rng.random(700) < 0.06
    query[2500:3200] = np.where(mut, (core + 1) % 4, core).astype(np.uint8)
    ref[3000:3010] = 4  # soft-masked stretch
    return ref, query


@pytest.mark.parametrize("S", [2, 8])
def test_shard_seed_table_copy_matches(S):
    from segalign_tpu.parallel.sharded import shard_seed_table as jax_shard
    ref, _ = _pair()
    tables = build_seed_table(ref, 1, SC.shape_pos, SC.size, SC.kmer_size)
    got, want = shard_seed_table(*tables, S), jax_shard(*tables, S)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # an empty table: one zero a shard
    empty = (np.zeros(16, np.int32), np.zeros(0, np.int32))
    for g, w in zip(shard_seed_table(*empty, S), jax_shard(*empty, S)):
        np.testing.assert_array_equal(g, w)


def test_exchange_is_an_all_to_all():
    cpu = [torch.device("cpu")] * 3
    send = [torch.arange(10 * s, 10 * s + 6).reshape(1, 6).repeat(2, 1)
            for s in range(3)]
    sizes = [[1, 2, 3], [0, 6, 0], [3, 0, 3]]
    recv = exchange(send, sizes, cpu)
    assert [r[0].tolist() for r in recv] == [
        [0, 20, 21, 22], [1, 2, 10, 11, 12, 13, 14, 15], [3, 4, 5, 23, 24, 25]]
    # the way back: the received columns, split by source, return home
    back = exchange(recv, [list(c) for c in zip(*sizes)], cpu)
    for b, s in zip(back, send):
        assert torch.equal(b, s)


def aligner_case(max_hits, chunk=512, rm=False):
    """(ref, query, the chunk work, the aligners' settings) of one case:
    the pair, or in rm_mode the self-alignment with a window."""
    ref, query = (_rm_seq(),) * 2 if rm else _pair()
    window = (200, 1200) if rm else None
    work = [ChunkWork(cs, ce, rev, window) for rev in (False, True)
            for (cs, ce) in chunk_interval(0, len(query) - SC.size, chunk)]
    kw = dict(shape_pos=SC.shape_pos, seed_size=SC.size,
              transition=SC.transition, step=1,
              sub_mat=build_substitution_matrix(910), xdrop=910,
              hspthresh=1500, noentropy=False, chunk_size=chunk,
              max_hits=max_hits, HBUF=1024, rm_mode=rm)
    return ref, query, work, kw


# digest(jax_results(max_hits, chunk, rm)), checked by test_jax_digests
JAX_SHA256 = {
    (10**9, 512, False):
        "4a8898fd0a676ade78319c528c307a24382448429963aa6288010e2d49fb179e",
    (256, 512, False):
        "c3a7e207918d7e58928992a99183d38b13f5db3620ae4a0cb8df74293dd67999",
    (64, 512, True):
        "e7c9d6d8fea1a1735654f48780a5682f1b24b43c627e58c8007888dae3ec1ba5",
    (64, 510, True):
        "34131aacfb9df7fb8727a2143d1b1facd011023b02dff89a5b1953885085e8d8"}


@functools.lru_cache(maxsize=None)
def jax_results(max_hits, chunk=512, rm=False):
    """What the JAX package's aligner gives for aligner_case(...),
    chunk-strand by chunk-strand in the order of its work."""
    from segalign_tpu.pipeline.device import DeviceAligner as JaxAligner
    ref, query, work, kw = aligner_case(max_hits, chunk, rm)
    al = JaxAligner(B=256, W=128, **kw)
    al.set_ref(ref)
    al.set_query(query, RC[query[::-1]])
    return [al.seed_and_filter(w.chunk_start, w.chunk_end, w.rev,
                               window=w.window) for w in work]


@pytest.mark.parametrize("key", sorted(JAX_SHA256), ids=str)
def test_jax_digests(key):
    assert digest(jax_results(*key)) == JAX_SHA256[key]


@functools.lru_cache(maxsize=None)
def replicated_results(max_hits, chunk=512, rm=False):
    """What the port's replicated DeviceAligner gives for
    aligner_case(...), chunk-strand by chunk-strand in the order of its
    work: the same for every number of shards."""
    ref, query, work, kw = aligner_case(max_hits, chunk, rm)
    al = DeviceAligner(device_seeding=True, device="cpu", **kw)
    al.set_ref(ref)
    al.set_query(query, RC[query[::-1]])
    return al.map_chunks(work)


def _assert_sharded_matches(S, max_hits, chunk=512, rm=False):
    ref, query, work, kw = aligner_case(max_hits, chunk, rm)
    got_al = ShardedAligner(num_devices=S, device="cpu", **kw)
    assert got_al.num_devices == S
    got_al.set_ref(ref)
    got_al.set_query(query, RC[query[::-1]])
    got = got_al.map_chunks(work)
    assert_same(got, jax_results(max_hits, chunk, rm))
    assert_same(got, replicated_results(max_hits, chunk, rm))


@pytest.mark.parametrize("max_hits", [10**9, 256])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_sharded_matches_replicated(S, max_hits):
    """max_hits 256 cuts a dense chunk-strand into several hit batches,
    whose limits must fall on the same seed slots as the replicated
    route's. The last chunk is shorter than chunk_size."""
    _assert_sharded_matches(S, max_hits)
    if max_hits == 256:
        assert max(r.num_hits for r in jax_results(256)) > 2 * 256


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_matches_replicated_rm_window(S):
    """A self-alignment in rm_mode with hits restricted to a window, a
    chunk size that S = 4 divides and one it does not."""
    for chunk in (512, 510):
        _assert_sharded_matches(S, 64, chunk, rm=True)


def test_shard_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert shard_devices("cpu", 2) == [cpu] * 2
    assert shard_devices("cpu", 7) == [cpu] * 4
    assert shard_devices("cuda:0", 4) == [torch.device("cuda", 0)] * 4
    for n in (-1, 0, 1):
        with pytest.raises(ValueError, match="needs >= 2 devices"):
            shard_devices("cpu", n)
    # `cuda` names the machine's cards by the farm's rule: a card a shard,
    # and more shards than cards is an error, not a second shard a card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert shard_devices("cuda", -1) == [c0, c1]
    assert shard_devices("cuda", 3) == [c0, c1]
    with pytest.raises(RuntimeError, match="this machine has 3"):
        shard_devices("cuda", 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        shard_devices("cuda", -1)


def _rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _pairwise_case(d):
    """The genomes and flags of tests/test_sharded_cli.py."""
    from segalign_tpu.cli.run_segalign import main as jax_main
    from segalign_tpu_torch.cli.run_segalign import main
    rng = np.random.default_rng(99)
    core1, core2 = _rand_dna(rng, 600), _rand_dna(rng, 400)
    rc_core2 = "".join(COMP[c] for c in reversed(core2))
    t_chr1 = _rand_dna(rng, 500) + core1 + _rand_dna(rng, 400)
    t_chr2 = _rand_dna(rng, 200) + core2 + _rand_dna(rng, 300)
    q_chr1 = _rand_dna(rng, 300) + core1 + _rand_dna(rng, 200)
    q_chr2 = _rand_dna(rng, 350) + rc_core2 + _rand_dna(rng, 250)
    ref_fa, query_fa = os.path.join(d, "target.fa"), os.path.join(d,
                                                                  "query.fa")
    write_fasta(ref_fa, [("t_chr1", t_chr1), ("t_chr2", t_chr2)])
    write_fasta(query_fa, [("q_chr1", q_chr1), ("q_chr2", q_chr2)])
    return jax_main, main, [ref_fa, query_fa, "--nogapped",
                            "--lastz_interval_size", "1000"]


def _rm_case(d):
    """The genome and flags of tests/test_sharded_rm.py."""
    from segalign_tpu.cli.run_segalign_repeat_masker import main as jax_main
    from segalign_tpu_torch.cli.run_segalign_repeat_masker import main
    rng = np.random.default_rng(17)
    rep = _rand_dna(rng, 250)
    rc_rep = "".join(COMP[c] for c in reversed(rep))
    chr1 = (_rand_dna(rng, 300) + rep + _rand_dna(rng, 150) + rc_rep +
            _rand_dna(rng, 250))
    chr2 = _rand_dna(rng, 200) + rep + _rand_dna(rng, 300)
    path = os.path.join(d, "seq.fa")
    write_fasta(path, [("chr1", chr1), ("chr2", chr2)])
    return jax_main, main, [path, "--lastz_interval_size", "700",
                            "--seq_block_size", "1400"]


@pytest.mark.parametrize("case", [_pairwise_case, _rm_case],
                         ids=["pairwise", "rm"])
def test_sharded_cli_byte_identical(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    """The JAX CLI with the replicated table on one device, then the
    port's with the replicated table and with four shards."""
    jax_main, main, argv = case(str(tmp_path))
    outs = []
    for name, run, extra in (
            ("jax", jax_main, ["--num_devices", "1"]),
            ("rep", main, ["--device", "cpu"]),
            ("shd", main, ["--device", "cpu", "--sharded_table",
                           "--num_devices", "4"])):
        out = str(tmp_path / name)
        assert run([*argv, "--output", out, "--markend", "--hspthresh",
                    "1500", "--noentropy", "--wga_chunk_size", "512",
                    "--workdir", str(tmp_path / f"w_{name}"), *extra]) == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0].count(b"\n") > 2   # content, not only the end mark
    assert outs[0] == outs[1] == outs[2]


def test_sharded_table_needs_two_devices(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for case in (_pairwise_case, _rm_case):
        _, main, argv = case(str(tmp_path))
        with pytest.raises(ValueError, match="--sharded_table needs >= 2"):
            main([*argv, "--sharded_table", "--num_devices", "1",
                  "--device", "cpu", "--output", str(tmp_path / "out")])
