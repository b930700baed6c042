"""The native route's seeding on the device, held to the host seeder, and
K1 on the padded sequences (first_scan_seq), held to the JAX package's
first windows.

The host seeder (native.ChunkSeeder, native/seeder.cpp, a copy of the JAX
package's) is no longer on any route: it is the check of the device's
seeding. On the CPU "the device's hits" are the same plain-torch route the
card runs (chunk_seeds, _batch_ends, expand_hits and the RM window in
DeviceAligner._seed_chunk and _program_hits). first_scan_seq's CPU
version is held to _first_steps_pallas in interpret mode (its kernel is
held to the CPU version in test_torch_cuda.py and chip_smoke.py). A numpy
model of the kernel's window copy (the aligned 16-byte blocks that cover a
window, the clip at the sequence's end, the shift into place) is held to
the gather it replaces. A few kb; about 8 s, most of it the four JAX
compiles."""

import numpy as np
import pytest
import torch

from segalign_tpu_torch import bench_inputs
from segalign_tpu_torch.config import build_substitution_matrix
from segalign_tpu_torch.io.encode import revcomp_codes
from segalign_tpu_torch.native import ChunkSeeder
from segalign_tpu_torch.ops.first_scan import first_scan_seq
from segalign_tpu_torch.ops.gather import gather_rows_plain
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


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W", [512, 256])
def test_first_scan_seq_equals_jax_first_steps(W, with_counts):
    """Exactly, every field of both states: first_scan_seq on the padded
    sequences against the JAX package's _first_steps_pallas (its two
    gathers and first_scan_pallas, in interpret mode), at the pipeline's
    pad and with anchors within W of both ends of both sequences."""
    import jax.numpy as jnp
    from segalign_tpu.ops.extend_fused import _first_steps_pallas
    from segalign_tpu_torch.ops.extend3 import STATE_KEYS, state_to_numpy
    from segalign_tpu_torch.ops.first_scan import first_scan
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
    before = (first_scan.launches, first_scan_seq.launches)
    got = first_scan_seq(ref, query, loc_r, loc_q, valid, SUB, 910, n_r,
                         n_q, pad=PAD, W=W, with_counts=with_counts)
    assert (first_scan.launches, first_scan_seq.launches) == before
    J = lambda t: jnp.asarray(t.numpy())
    st = {"done": J(~valid)}
    (want_r, _), (want_l, _) = _first_steps_pallas(
        J(ref), J(query), J(loc_r), J(loc_q), st, st, J(SUB), 910, n_r,
        n_q, pad=PAD, W=W, interpret=True, with_counts=with_counts)
    for g, w in zip(got, (want_r, want_l)):
        g = state_to_numpy(g)
        for k in STATE_KEYS:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
        assert (~g["done"]).sum() > 0 and g["done"].sum() > 0


def _copy_window_model(seq: np.ndarray, s: int, L: int) -> np.ndarray:
    """csrc/first_scan.cu copy_windows for one sequence in numpy: the
    L // 16 + 1 aligned 16-byte blocks from s & ~15 (bytes past the
    sequence 0), then the copy shifted left by s & 15 bytes, word by word
    with funnel shifts (shift_copy)."""
    n, a0, nblk = len(seq), s & ~15, L // 16
    buf = np.zeros(L + 16, np.uint8)
    for k in range(nblk + 1):
        part = seq[a0 + 16 * k:min(a0 + 16 * k + 16, n)]
        buf[16 * k:16 * k + len(part)] = part
    mis = s & 15
    if mis:
        words = buf.view("<u4").astype(np.uint64)
        ws, sh = mis >> 2, 8 * (mis & 3)
        i = np.arange(L // 4) + ws
        pair = (words[i + 1] << np.uint64(32)) | words[i]
        buf[:L] = ((pair >> np.uint64(sh)) & np.uint64(0xFFFFFFFF)).astype(
            "<u4").view(np.uint8)
    return buf[:L]


def _window_start_model(pad: int, loc: int, W: int, n: int) -> int:
    """csrc/first_scan.cu window_start: pad + loc - W wrapped to int32,
    clamped to [0, n - 2W]."""
    s = (pad + loc - W + 2**31) % 2**32 - 2**31
    return min(max(s, 0), n - 2 * W)


@pytest.mark.parametrize("W", [512, 256, 80])
def test_window_copy_model_equals_the_gather(W):
    """Every anchor's 2W-wide window (the kernel scans its first W bytes
    leftwards and the next W rightwards), at every offset within a 16-byte
    block, near both ends of a sequence whose length is not a multiple of
    16 (the last block partial), with starts the clamp moves and a start
    that wraps in int32."""
    rng = np.random.default_rng(W)
    n = 3 * W + 16 * 37 + 9
    seq = rng.integers(0, 256, n).astype(np.uint8)
    pad = W // 2
    locs = np.concatenate([np.arange(0, 40), n - pad - np.arange(0, 40),
                           rng.integers(-W, n, 200), [2**31 - 1 - pad // 2]])
    t = torch.from_numpy(seq)
    want = gather_rows_plain(
        t, pad + torch.from_numpy(locs.astype(np.int32)) - W, 2 * W).numpy()
    for loc, row in zip(locs, want):
        s = _window_start_model(pad, int(loc), W, n)
        np.testing.assert_array_equal(_copy_window_model(seq, s, 2 * W),
                                      row, err_msg=str(loc))
