"""The native route's seeding on the device, held to the host seeder, and
K1 on the padded sequences (first_scan_seq), held to the JAX package's
first windows.

The host seeder (native.ChunkSeeder, native/seeder.cpp, a copy of the JAX
package's) is no longer on any route: it is the check of the device's
seeding. On the CPU "the device's hits" are the same plain-torch route the
card runs (chunk_seeds, _batch_ends, expand_hits and the RM window in
DeviceAligner._seed_chunk and _program_hits). first_scan_seq's CPU
version is held to _first_steps_pallas in interpret mode (its kernel is
held to the CPU version in test_torch_cuda.py and chip_smoke.py), and so
is the numpy model of the kernel's walk (first_scan_rows_model.py, held to
the CPU version in test_torch_first_scan_rows.py), on the same inputs. A
few kb; about 8 s, most of it the four JAX compiles."""

import os
import sys

import numpy as np
import pytest
import torch

from segalign_tpu_torch import bench_inputs
from segalign_tpu_torch.config import build_substitution_matrix
from segalign_tpu_torch.io.encode import revcomp_codes
from segalign_tpu_torch.native import ChunkSeeder
from segalign_tpu_torch.ops.first_scan import first_scan_seq
from segalign_tpu_torch.ops.padding import pad_sequence
from segalign_tpu_torch.pipeline.device import PAD, DeviceAligner

SUB = torch.from_numpy(
    build_substitution_matrix(910).reshape(-1).astype(np.int32))


def _aligner(mode):
    """A CPU aligner with programs of 64 hits over a pair of a few kb with
    shared cores, Ns and soft-masked bases; its work, each chunk-strand
    with the RM window in mode "rm"."""
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 3000).astype(np.uint8)
    query = rng.integers(0, 4, 2600).astype(np.uint8)
    core = rng.integers(0, 4, 500).astype(np.uint8)
    ref[300:800] = ref[1900:2400] = core
    query[500:1000] = core
    ref[1000:1020] = 4
    query[100:110] = 5
    kw = dict(bench_inputs.aligner_settings("cpu"), hspthresh=1500,
              chunk_size=512, HBUF=64,
              max_hits=64 if mode == "max_hits" else 10**9)
    if mode == "rm":
        al = DeviceAligner(rm_mode=True, **kw)
        al.set_ref(ref)
        al.set_query(ref, revcomp_codes(ref))
        work = [(w.chunk_start, w.chunk_end, w.rev, (400, 2200))
                for w in bench_inputs.chunk_work(ref, 512)]
    else:
        al = DeviceAligner(**kw)
        al.set_ref(ref)
        al.set_query(query, revcomp_codes(query))
        work = [(w.chunk_start, w.chunk_end, w.rev, None)
                for w in bench_inputs.chunk_work(query, 512)]
    return al, work


@pytest.mark.parametrize("mode", ["plain", "rm", "max_hits"])
def test_device_hits_equal_the_host_seeders(mode):
    """Every chunk-strand: seeds, hits and logical batch ends equal
    ChunkSeeder.seed's, and the hits the programs extend are the host's
    hits in order (in the RM window only), each at its index in the host's
    hit stream."""
    al, work = _aligner(mode)
    seeder = ChunkSeeder(al.chunk_size, al.kmer_size, al.transition)
    it, pt = al._host_tables
    n_hits = n_kept = 0
    max_batches = 0
    for cs, ce, rev, window in work:
        q = al._q_rc_host if rev else al._q_fw_host
        ref_loc, query_loc, _, hit_bound, num_seeds, num_hits = seeder.seed(
            q, cs, ce - cs, it, pt, al.shape_pos, al.seed_size, al.max_hits)
        s = al._seed_chunk(cs, ce, rev, window)
        assert (s.num_seeds, s.num_hits) == (num_seeds, num_hits)
        np.testing.assert_array_equal(s.seg_ends, hit_bound)
        progs = [al._program_hits(s, g0)
                 for g0 in range(0, s.num_hits, al.HBUF)]
        got = [np.concatenate([p[i].numpy() for p in progs] or
                              [np.zeros(0, np.int32)]) for i in range(3)]
        keep = np.ones(num_hits, bool)
        if window is not None:
            keep = (ref_loc >= window[0]) & (ref_loc <= window[1])
        np.testing.assert_array_equal(got[0], ref_loc[keep])
        np.testing.assert_array_equal(got[1], query_loc[keep])
        np.testing.assert_array_equal(got[2], np.nonzero(keep)[0])
        n_hits += num_hits
        n_kept += int(keep.sum())
        max_batches = max(max_batches, len(hit_bound))
    assert n_hits > 8 * al.HBUF
    if mode == "rm":
        assert 0 < n_kept < n_hits
    if mode == "max_hits":   # batches cut by max_hits, and the last seed's
        assert max_batches > 2


def _anchors(rng, n_r, n_q, W, B=128):
    """Anchors across both sequences, with rows within W of both ends of
    both sequences and at the ends themselves."""
    loc_r = rng.integers(0, n_r + 1, B).astype(np.int32)
    loc_q = rng.integers(0, n_q + 1, B).astype(np.int32)
    edges = np.array([0, 1, 15, 16, 17, W - 1, W, W + 1])
    loc_r[:8], loc_q[:8] = edges, edges[::-1]
    loc_r[8:16], loc_q[8:16] = n_r - edges, n_q - edges
    loc_r[16:24], loc_q[16:24] = edges, n_q - edges
    loc_r[24:32], loc_q[24:32] = n_r - edges, edges
    return torch.from_numpy(loc_r), torch.from_numpy(loc_q)


def _padded(rng, n):
    """The pipeline's layout (pad_sequence at PAD, the bytes of the JAX
    package's pad_sequence_2d) of a random sequence with an N run."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[n // 3:n // 3 + 40] = 4
    return torch.from_numpy(pad_sequence(codes, PAD))


def _first_rows(W, with_counts):
    """The padded sequences and anchors of the first-window tests, with a
    repeated core, and the JAX package's _first_steps_pallas on them (its
    two gathers and first_scan_pallas, in interpret mode): (ref, query,
    loc_r, loc_q, valid, n_r, n_q, (want_right, want_left))."""
    import jax.numpy as jnp
    from segalign_tpu.ops.extend_fused import _first_steps_pallas
    rng = np.random.default_rng([W, with_counts])
    n_r, n_q = 2500, 2200   # padded to one length: one gather compiled
    ref, query = _padded(rng, n_r), _padded(rng, n_q)
    core = torch.from_numpy(rng.integers(0, 4, 700).astype(np.uint8))
    ref[PAD + 1000:PAD + 1700] = query[PAD + 600:PAD + 1300] = core
    loc_r, loc_q = _anchors(rng, n_r, n_q, W)
    loc_r[40:120] = torch.arange(1050, 1610, 7, dtype=torch.int32)
    loc_q[40:120] = loc_r[40:120] - 400
    valid = torch.from_numpy(rng.random(loc_r.numel()) > 0.1)
    valid[:32] = True
    J = lambda t: jnp.asarray(t.numpy())
    st = {"done": J(~valid)}
    (want_r, _), (want_l, _) = _first_steps_pallas(
        J(ref), J(query), J(loc_r), J(loc_q), st, st, J(SUB), 910, n_r,
        n_q, pad=PAD, W=W, interpret=True, with_counts=with_counts)
    return ref, query, loc_r, loc_q, valid, n_r, n_q, (want_r, want_l)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W", [512, 256])
def test_first_scan_seq_equals_jax_first_steps(W, with_counts):
    """Exactly, every field of both states: first_scan_seq on the padded
    sequences against the JAX package's _first_steps_pallas (its two
    gathers and first_scan_pallas, in interpret mode), at the pipeline's
    pad and with anchors within W of both ends of both sequences."""
    from segalign_tpu_torch.ops.extend3 import STATE_KEYS, state_to_numpy
    from segalign_tpu_torch.ops.first_scan import first_scan
    ref, query, loc_r, loc_q, valid, n_r, n_q, want = _first_rows(
        W, with_counts)
    before = (first_scan.launches, first_scan_seq.launches)
    got = first_scan_seq(ref, query, loc_r, loc_q, valid, SUB, 910, n_r,
                         n_q, pad=PAD, W=W, with_counts=with_counts)
    assert (first_scan.launches, first_scan_seq.launches) == before
    for g, w in zip(got, want):
        g = state_to_numpy(g)
        for k in STATE_KEYS:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
        assert (~g["done"]).sum() > 0 and g["done"].sum() > 0


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W", [512, 256])
def test_first_scan_rows_model_equals_jax_first_steps(W, with_counts):
    """The numpy model of the kernel's walk (a thread a row and direction,
    the warp's phases, the counts snapshot) against _first_steps_pallas on
    the same inputs, every field exactly."""
    from segalign_tpu_torch.ops.extend3 import STATE_KEYS
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from first_scan_rows_model import k1s_model
    ref, query, loc_r, loc_q, valid, n_r, n_q, want = _first_rows(
        W, with_counts)
    got, _ = k1s_model(ref.numpy(), query.numpy(), loc_r.numpy(),
                       loc_q.numpy(), valid.numpy(), SUB.numpy(), 910, n_r,
                       n_q, pad=PAD, W=W, with_counts=with_counts)
    for g, w in zip(got, want):
        for k in STATE_KEYS:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
