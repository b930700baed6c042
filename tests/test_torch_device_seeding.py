"""The port's device-seeding route against the JAX package's.

chunk_seeds, expand_hits and compact_mask against the JAX functions on the
same padded inputs; the host-stepped windowed engine against JAX's
extend_hits_windowed with its XLA step and with its Pallas step (K5 in
interpret mode); and DeviceAligner(device_seeding=True) against the JAX
aligner's device-seeding route per chunk-strand. Integers throughout:
equality is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segalign_tpu.config import build_substitution_matrix, make_seed_config
from segalign_tpu.index.seed_table import build_seed_table
from segalign_tpu.io.blocks import chunk_interval
from segalign_tpu.ops import extend3 as jx
from segalign_tpu.ops import hits as jhits
from segalign_tpu.ops.seeding import chunk_seeds as jax_chunk_seeds
from segalign_tpu.pipeline import device as jdevice
from segalign_tpu_torch.ops.extend3 import extend_hits_windowed
from segalign_tpu_torch.ops.hits import compact_mask, expand_hits
from segalign_tpu_torch.ops.padding import pad_sequence
from segalign_tpu_torch.ops.seeding import chunk_seeds
from segalign_tpu_torch.ops.window_scan_wide import window_scan_wide
from segalign_tpu_torch.pipeline.device import DeviceAligner

RC = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)
SC = make_seed_config("12of19")
SUB = build_substitution_matrix(910)
SUB_FLAT = SUB.reshape(-1).astype(np.int32)
T = torch.from_numpy
CHUNK, PAD = 512, 64


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


def _seeding_inputs(transition):
    sc = make_seed_config("12of19", not transition)
    ref, query = make_pair(np.random.default_rng(42))
    it, pt = build_seed_table(ref, 1, sc.shape_pos, sc.size, sc.kmer_size)
    qp = pad_sequence(query, PAD, CHUNK + sc.size + 1)
    return sc, query, qp, it.astype(np.int32), pt.astype(np.int32)


def _port_seeds(sc, qp, it, cs, ln):
    return chunk_seeds(T(qp), T(it), cs, ln, CHUNK=CHUNK, seed_size=sc.size,
                       shape_pos=sc.shape_pos, transition=sc.transition,
                       pad=PAD)


def _jax_seeds(sc, qp, it, cs, ln):
    return jax_chunk_seeds(jnp.asarray(qp), jnp.asarray(it), cs, ln,
                           CHUNK=CHUNK, seed_size=sc.size,
                           shape_pos=sc.shape_pos, transition=sc.transition,
                           pad=PAD)


@pytest.mark.parametrize("transition", [True, False])
def test_chunk_seeds_matches_jax(transition):
    sc, query, qp, it, _ = _seeding_inputs(transition)
    q_len = len(query) - sc.size
    chunks = list(chunk_interval(0, q_len, CHUNK))
    assert chunks[-1][1] - chunks[-1][0] < CHUNK   # a short last chunk
    hits = 0
    for cs, ce in chunks:
        got = _port_seeds(sc, qp, it, cs, ce - cs)
        want = _jax_seeds(sc, qp, it, cs, ce - cs)
        for name, g, w in zip(("kmers", "qpos", "valid", "starts", "cum",
                               "stats"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} {cs}:{ce}")
        assert got[4].dtype == torch.int32
        hits += int(got[5][1])
    assert hits > 0


def test_chunk_seeds_short_query_raises():
    sc, query, _, it, _ = _seeding_inputs(True)
    qp = pad_sequence(query, PAD)   # no right pad for the last chunk
    with pytest.raises(ValueError, match="too short"):
        _port_seeds(sc, qp, it, len(query) - 100, 80)


def test_expand_hits_matches_jax():
    sc, query, qp, it, pt = _seeding_inputs(True)
    _, qpos, _, starts, cum, stats = _port_seeds(sc, qp, it, 512, CHUNK)
    num_hits = int(stats[1])
    assert num_hits > 300
    HBUF = 256
    for g0, g1 in ((0, HBUF), (100, 300), (num_hits - 50, num_hits)):
        got = expand_hits(cum, starts, qpos, T(pt), g0, g1, sc.size,
                          HBUF=HBUF)
        want = jhits.expand_hits(
            jnp.asarray(cum.numpy()), jnp.asarray(starts.numpy()),
            jnp.asarray(qpos.numpy()), jnp.asarray(pt), g0, g1, sc.size,
            HBUF=HBUF)
        for name, g, w in zip(("ref_loc", "query_loc", "valid"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} {g0}:{g1}")


def test_compact_mask_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.random(300) < 0.3
    a = rng.integers(-9, 9, 300).astype(np.int32)
    b = rng.integers(0, 99, (300, 4)).astype(np.int32)
    got = compact_mask(T(mask), T(a), T(b))
    want = jhits.compact_mask(jnp.asarray(mask), jnp.asarray(a),
                              jnp.asarray(b))
    assert int(got[0]) == int(want[0]) == mask.sum()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _engine_case():
    """Hits on a shared core (long extensions over several windows), at
    both sequence ends and beside walls, some invalid."""
    rng = np.random.default_rng(11)
    n, B = 4000, 256
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, 1500).astype(np.uint8)
    ref[800:2300] = core
    query[1500:3000] = core
    ref[[1700, 3500]] = 7
    query[2900] = 7
    ref[200:230] = 4
    query[400:420] = 5
    rl = rng.integers(0, n, B).astype(np.int32)
    ql = rng.integers(0, n, B).astype(np.int32)
    d = B // 3
    off = rng.integers(20, 1480, d).astype(np.int32)
    rl[:d] = 800 + off
    ql[:d] = 1500 + off
    rl[d:d + 8] = [0, 1, 5, n - 1, n - 2, n - 40, 1695, 3490]
    ql[d:d + 8] = [3, 0, n - 1, n - 3, 7, n - 41, 2395, 2890]
    valid = rng.random(B) > 0.05
    return ref, query, rl, ql, valid, n


@pytest.mark.parametrize("pallas", [False, True])
def test_extend_hits_windowed_matches_jax(pallas, monkeypatch):
    """The port's engine against JAX's with the XLA window step, and with
    the Pallas route (gather, then window_scan_pallas in interpret mode),
    whose scan the port's K5 replaces."""
    monkeypatch.setattr(jx, "_USE_PALLAS", pallas)
    ref, query, rl, ql, valid, n = _engine_case()
    W = 256
    rp, qp = pad_sequence(ref, W), pad_sequence(query, W)
    want = jx.extend_hits_windowed(
        jnp.asarray(rp), jnp.asarray(qp), jnp.asarray(rl), jnp.asarray(ql),
        jnp.asarray(valid), jnp.asarray(SUB_FLAT), 910, 3000, n, n, pad=W,
        W=W)
    before = window_scan_wide.launches
    got = extend_hits_windowed(T(rp), T(qp), T(rl), T(ql), T(valid),
                               T(SUB_FLAT), 910, 3000, n, n, pad=W, W=W)
    assert window_scan_wide.launches == before
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # candidates whose extensions ran over several windows
    assert (got["candidate"] & (got["length"] > 3 * W)).sum() > 0


def _aligner_kw(max_hits):
    return dict(shape_pos=SC.shape_pos, seed_size=SC.size,
                transition=SC.transition, step=1, sub_mat=SUB, xdrop=910,
                hspthresh=1500, noentropy=False, chunk_size=512,
                max_hits=max_hits)


@pytest.mark.parametrize("max_hits", [10**9, 64])
def test_device_seeding_aligner_matches_jax(max_hits, monkeypatch):
    """Per chunk-strand HSPs of the port's device route against the JAX
    aligner's device route, and the port's native route; max_hits 64 cuts
    each chunk-strand into many logical batches."""
    monkeypatch.setattr(jdevice, "_FORCE_DEVICE_SEEDING", True)
    ref, query = make_pair(np.random.default_rng(42))
    qrc = RC[query[::-1]]
    # ranges of 256 hits: a logical batch spans several of them
    jax_al = jdevice.DeviceAligner(HBUF=256, B=256, W=128,
                                   **_aligner_kw(max_hits))
    assert jax_al._native_seeder is None
    dev_route = DeviceAligner(device="cpu", HBUF=256, device_seeding=True,
                              **_aligner_kw(max_hits))
    native = DeviceAligner(device="cpu", HBUF=256, **_aligner_kw(max_hits))
    for al in (jax_al, dev_route, native):
        al.set_ref(ref)
        al.set_query(query, qrc)
    total = 0
    for (cs, ce) in chunk_interval(0, len(query) - SC.size, 512):
        for rev in (False, True):
            want = jax_al.seed_and_filter(cs, ce, rev)
            for al in (dev_route, native):
                got = al.seed_and_filter(cs, ce, rev)
                assert (got.num_hits, got.num_seeds) == (want.num_hits,
                                                         want.num_seeds)
                np.testing.assert_array_equal(
                    got.hsps, want.hsps, err_msg=f"{cs}:{ce} rev={rev}")
            total += len(want.hsps)
    assert total > 0


def test_device_route_map_chunks_matches_sequential():
    from segalign_tpu_torch.parallel.multi import ChunkWork
    ref, query = make_pair(np.random.default_rng(42))
    al = DeviceAligner(device="cpu", HBUF=1024, device_seeding=True,
                       **_aligner_kw(10**9))
    al.set_ref(ref)
    al.set_query(query, RC[query[::-1]])
    work = [ChunkWork(cs, ce, rev)
            for (cs, ce) in chunk_interval(0, len(query) - SC.size, 512)
            for rev in (False, True)]
    seen = []
    got = al.map_chunks(work, on_result=lambda i, r: seen.append(i))
    assert seen == list(range(len(work)))
    for w, r in zip(work, got):
        want = al.seed_and_filter(w.chunk_start, w.chunk_end, w.rev)
        np.testing.assert_array_equal(r.hsps, want.hsps)
