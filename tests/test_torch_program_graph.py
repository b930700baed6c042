"""The native route's programs as device programs (pipeline/program.py),
on the CPU, where extend_program runs eagerly: the route here and the
reference of the CUDA graph that replays it on the card
(tests/test_torch_cuda.py holds the replays to it there).

A chunk-strand's programs with an RM window, a partial last program and
logical batches cut by max_hits, then the pack: the rows that the JAX
_pack_compact(dedup_exact=True) keeps of the same hits' fields, in its
order; a candidate buffer of one row, which the finisher's extension
again fills with the same rows; no host sync from the first program to
the pack; the launches a capture records, counted at each replay."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segalign_tpu.pipeline.device import _pack_compact as jax_pack
from segalign_tpu_torch import bench_inputs
from segalign_tpu_torch.io.encode import revcomp_codes
from segalign_tpu_torch.native import ChunkSeeder
from segalign_tpu_torch.ops import first_scan, launches, window_scan
from segalign_tpu_torch.ops.extend_fused import extend_fields
from segalign_tpu_torch.pipeline import program
from segalign_tpu_torch.pipeline.device import (CONT_W, PAD, DeviceAligner,
                                                NO_WINDOW)

CHUNK = 20_000
HBUF = 64


@pytest.fixture(scope="module")
def pair():
    ref, query = bench_inputs.load_inputs(0.05, 0.05)
    return ref, query, revcomp_codes(query)


def _aligner(pair, **kw):
    ref, query, qrc = pair
    al = DeviceAligner(**{**bench_inputs.aligner_settings("cpu"),
                          "chunk_size": CHUNK, "HBUF": HBUF, **kw})
    al.set_ref(ref)
    al.set_query(query, qrc)
    return al


def _jax_rows(al, window):
    """The JAX pack of chunk 0's forward hits, from the host seeder, in
    programs of HBUF rows whose fields are extend_fields' with the rows
    outside the window masked."""
    it, pt = al._host_tables
    ref_loc, query_loc, _, hit_bound, _, n = ChunkSeeder(
        al.chunk_size, al.kmer_size, al.transition).seed(
            al._q_fw_host, 0, CHUNK, it, pt, al.shape_pos, al.seed_size,
            al.max_hits)
    lo, hi = window or NO_WINDOW
    fins = []
    for g0 in range(0, n, HBUF):
        r = torch.from_numpy(ref_loc[g0:g0 + HBUF])
        q = torch.from_numpy(query_loc[g0:g0 + HBUF])
        fin = extend_fields(al.ref_pad, al.q_fw, r, q,
                            (r >= lo) & (r <= hi), al.sub, al.xdrop,
                            al.hspthresh, al.ref_len, al.q_len, pad=PAD,
                            W=al.window, W_CONT=CONT_W, with_counts=False)
        fins.append({**{k: jnp.asarray(v.numpy()) for k, v in fin.items()},
                     "orig": jnp.arange(g0, g0 + len(r), dtype=jnp.int32)})
    total, rows = jax_pack(fins, jnp.asarray(np.asarray(hit_bound)),
                           TBUF=n, dedup_exact=True)
    return np.asarray(rows)[:int(total)], n, len(hit_bound)


@pytest.mark.parametrize("window", [None, (3_000, 40_000)],
                         ids=["plain", "rm_window"])
def test_programs_and_pack_keep_the_jax_packs_rows(pair, window):
    """Every program of chunk 0's forward strand (the last one partial,
    max_hits cutting the hits into batches inside programs), then the
    pack: the JAX pack's rows in its order."""
    al = _aligner(pair, max_hits=150)
    want, n, batches = _jax_rows(al, window)
    s = al._seed_chunk(0, CHUNK, False, window, into=al._buffers())
    assert s.num_hits == n and n % HBUF and n > 3 * HBUF and batches > 3
    al._dispatch_rows(s)
    out, counts = program.pack_candidates(al._buf, al._kept_rows)
    kept, appended = counts.tolist()
    assert kept <= appended <= al._buf.cand_rows
    np.testing.assert_array_equal(out[:kept].numpy(), want)
    assert 0 < kept


def _rows_and_hsps(al):
    """finish_chunk(dispatch_chunk()) of chunk 0's forward strand, and the
    rows the finisher fetched."""
    seen = []
    split = al._split_and_finalize
    al._split_and_finalize = lambda rows, p: seen.append(rows) or split(
        rows, p)
    r = al.finish_chunk(al.dispatch_chunk(0, CHUNK, False))
    return seen[0], r


def test_a_buffer_of_one_row_extends_again_to_the_same_rows(pair):
    """A candidate buffer of one row: the finisher extends the chunk-strand
    again into a buffer of twice its count, once, and fetches the rows and
    gives the HSPs of a buffer that fits."""
    want_rows, want = _rows_and_hsps(_aligner(pair))
    al = _aligner(pair)
    al._cand_rows = 1
    rows, got = _rows_and_hsps(al)
    assert want.reextended == 0 and got.reextended == 1
    appended = len(want_rows)
    assert al._buf.cand_rows >= 2 * appended > 2
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(got.hsps, want.hsps)
    assert len(got.hsps) > 0


class _NoSync:
    """torch.nonzero and Tensor.item, tolist, cpu, __bool__ and __int__
    raise while `banned`; the kernels' plain versions (first_scan_seq's
    and window_scan_seq's, which stand in on the CPU for kernels that
    never wait for the card) are let through."""

    def __init__(self, monkeypatch):
        self.banned = False
        for owner, name in ((torch, "nonzero"), (torch.Tensor, "item"),
                            (torch.Tensor, "tolist"), (torch.Tensor, "cpu"),
                            (torch.Tensor, "__bool__"),
                            (torch.Tensor, "__int__")):
            monkeypatch.setattr(owner, name, self._guard(getattr(owner,
                                                                 name)))
        for mod, name in ((first_scan, "first_scan_seq_plain"),
                          (window_scan, "window_scan_seq_plain")):
            monkeypatch.setattr(mod, name, self._free(getattr(mod, name)))

    def _guard(self, fn):
        def guarded(*a, **kw):
            if self.banned:
                raise AssertionError(f"host sync: {fn.__name__}")
            return fn(*a, **kw)
        return guarded

    def _free(self, fn):
        def free(*a, **kw):
            banned, self.banned = self.banned, False
            try:
                return fn(*a, **kw)
            finally:
                self.banned = banned
        return free


def test_programs_and_pack_make_no_host_sync(pair, monkeypatch):
    """From the first program to the pack (_extend_seeded) nothing reads a
    device value; the finisher's fetch then gives the rows of the same
    programs run without the ban."""
    al = _aligner(pair, max_hits=150)
    want = al.finish_chunk(al.dispatch_chunk(0, CHUNK, False, (3_000,
                                                               40_000)))
    s = al._seed_chunk(0, CHUNK, False, (3_000, 40_000),
                       into=al._buffers())
    ban = _NoSync(monkeypatch)
    ban.banned = True
    try:
        p = al._extend_seeded(s)
    finally:
        ban.banned = False
    got = al.finish_chunk(p)
    assert len(want.hsps) > 0
    np.testing.assert_array_equal(got.hsps, want.hsps)
    ban.banned = True
    with pytest.raises(AssertionError, match="host sync"):
        torch.nonzero(torch.ones(2))
    ban.banned = False


def test_a_recorded_launch_counts_at_each_replay():
    """count_launch inside recording() counts nothing and records the
    launch; ProgramGraph.replay counts what its capture recorded, once a
    replay (the replay is stubbed: there is no card here)."""
    fn = window_scan.window_scan_seq
    before = fn.launches
    with launches.recording() as rec:
        launches.count_launch(fn)
        launches.count_launch(first_scan.first_scan_seq)
    assert fn.launches == before and len(rec) == 2
    launches.count_launch(fn)
    assert fn.launches == before + 1
    graph = program.ProgramGraph.__new__(program.ProgramGraph)
    graph.graph = type("Stub", (), {"replay": lambda self: None})()
    graph.launches, graph.outputs = rec, None
    k1s = first_scan.first_scan_seq.launches
    for _ in range(3):
        graph.replay()
    assert fn.launches == before + 4
    assert first_scan.first_scan_seq.launches == k1s + 3
