"""The native route's map_chunks: the calling thread seeds each chunk on
the device and extends it, and a finisher thread finishes the chunks
before.

On the CPU at a tiny size (a few kb, 256-512 bp chunks, 10-12
chunk-strands): the overlapped map_chunks against its serial form
(SEGALIGN_OVERLAP=0) and against seed_and_filter chunk by chunk, which
tests/test_torch_pipeline.py holds to the JAX package; which thread runs
each stage; and that an error of the seeding or of the extension raises
at its chunk with no finisher work left running."""

import threading
import time

import numpy as np
import pytest

from segalign_tpu_torch import bench_inputs
from segalign_tpu_torch.io.encode import revcomp_codes
from segalign_tpu_torch.parallel.multi import ChunkWork
from segalign_tpu_torch.pipeline.device import DeviceAligner


def make_pair(rng, n_ref=2200, n_query=2600):
    """An exact and a diverged shared core, a soft-masked stretch and Ns
    (the pair of tests/test_torch_pipeline.py)."""
    ref = rng.integers(0, 4, n_ref).astype(np.uint8)
    query = rng.integers(0, 4, n_query).astype(np.uint8)
    core = rng.integers(0, 4, 400).astype(np.uint8)
    ref[300:700] = core
    query[500:900] = core
    mut = rng.random(400) < 0.05
    ref[1200:1600] = np.where(mut, (core + 1) % 4, core)
    query[1500:1900] = core
    ref[1000:1020] = 4
    query[100:110] = 5
    return ref, query


def rm_sequence(rng, n=1500):
    """A sequence with an internal repeat, aligned against itself (the
    repeat masker's case of tests/test_torch_repeat_masker.py)."""
    seq = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, 300).astype(np.uint8)
    seq[100:400] = core
    seq[800:1100] = core
    return seq


def aligner(mode):
    """An aligner on the CPU set up for `mode`, and its work."""
    kw = dict(bench_inputs.aligner_settings("cpu"), hspthresh=1500,
              chunk_size=512, max_hits=64 if mode == "max_hits" else 10**9)
    if mode == "rm":
        seq = rm_sequence(np.random.default_rng(7))
        al = DeviceAligner(rm_mode=True, HBUF=256,
                           **dict(kw, chunk_size=256))
        al.set_ref(seq)
        al.set_query(seq, revcomp_codes(seq))
        work = [ChunkWork(w.chunk_start, w.chunk_end, w.rev, (200, 1200))
                for w in bench_inputs.chunk_work(seq, 256)]
        return al, work
    ref, query = make_pair(np.random.default_rng(42))
    al = DeviceAligner(HBUF=256, **kw)
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    return al, bench_inputs.chunk_work(query, 512)


def assert_same(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a.num_hits, a.num_seeds, a.num_batches) == (
            b.num_hits, b.num_seeds, b.num_batches), i
        np.testing.assert_array_equal(a.hsps, b.hsps, err_msg=str(i))


@pytest.mark.parametrize("mode", ["plain", "rm", "max_hits"])
def test_overlapped_equals_serial_and_per_chunk(mode, monkeypatch):
    al, work = aligner(mode)
    want = [al.seed_and_filter(w.chunk_start, w.chunk_end, w.rev,
                               window=w.window) for w in work]
    monkeypatch.setenv("SEGALIGN_OVERLAP", "0")
    serial = al.map_chunks(work, depth=2)
    monkeypatch.delenv("SEGALIGN_OVERLAP")
    order = []
    piped = al.map_chunks(work, depth=2,
                          on_result=lambda i, r: order.append((i, r)))
    assert_same(serial, want)
    assert_same(piped, want)
    assert [i for i, _ in order] == list(range(len(work)))
    assert all(r is piped[i] for i, r in order)
    assert 10 <= len(work) <= 12
    assert sum(len(r.hsps) for r in want) > 0
    if mode == "max_hits":
        # more than one batch of hits plus the last seed's own
        assert max(r.num_batches for r in want) > 2
    if mode == "rm":
        assert al.rm_mode and all(w.window for w in work)


class Recorder:
    """Wraps an aligner's _seed_chunk, _extend_seeded and finish_chunk:
    which thread runs each call, in call order (each is called once a
    chunk-strand, in work order), and how many finish_chunk calls run
    now."""

    def __init__(self, al):
        self.lock = threading.Lock()
        self.threads = {"seed": [], "extend": [], "finish": []}
        self.seeds_done = 0
        self.finishing = 0          # finish_chunk calls running now
        self.hooks = {}             # stage: fn(call index), at its start
        seed, extend, finish = (al._seed_chunk, al._extend_seeded,
                                al.finish_chunk)

        def wrap(stage, fn):
            def rec(*a, **kw):
                with self.lock:
                    k = len(self.threads[stage])
                    self.threads[stage].append(threading.get_ident())
                    if stage == "finish":
                        self.finishing += 1
                try:
                    if stage in self.hooks:
                        self.hooks[stage](k)
                    out = fn(*a, **kw)
                    if stage == "seed":
                        with self.lock:
                            self.seeds_done += 1
                    return out
                finally:
                    if stage == "finish":
                        with self.lock:
                            self.finishing -= 1
            return rec

        al._seed_chunk = wrap("seed", seed)
        al._extend_seeded = wrap("extend", extend)
        al.finish_chunk = wrap("finish", finish)


def test_overlapped_form_seeds_on_the_dispatch_thread(monkeypatch):
    """The default form seeds and extends every chunk on the calling
    thread, in turn, and finishes them on one other thread."""
    monkeypatch.delenv("SEGALIGN_OVERLAP", raising=False)
    al, work = aligner("plain")
    want = [al.seed_and_filter(w.chunk_start, w.chunk_end, w.rev)
            for w in work]
    rec = Recorder(al)
    assert_same(al.map_chunks(work), want)
    me = threading.get_ident()
    n = len(work)
    assert rec.threads["seed"] == rec.threads["extend"] == [me] * n
    finishers = set(rec.threads["finish"])
    assert len(rec.threads["finish"]) == n and len(finishers) == 1
    assert me not in finishers and rec.finishing == 0


def test_serial_form_seeds_on_the_calling_thread(monkeypatch):
    monkeypatch.setenv("SEGALIGN_OVERLAP", "0")
    al, work = aligner("plain")
    rec = Recorder(al)
    al.map_chunks(work)
    me = threading.get_ident()
    assert all(set(t) == {me} for t in rec.threads.values())
    assert rec.seeds_done == len(work)


def test_seeding_error_raises_at_its_chunk(monkeypatch):
    """The hit ceiling (SEGALIGN_MAX_CHUNK_HITS) at a chunk-strand after
    the first: map_chunks raises it at that chunk's turn, after extending
    the chunks before it and seeding none after it, with no finisher work
    left running; the aligner then maps the same work as before."""
    monkeypatch.delenv("SEGALIGN_OVERLAP", raising=False)
    al, work = aligner("plain")
    want = al.map_chunks(work)
    hits = [r.num_hits for r in want]
    k = next(i for i, h in enumerate(hits) if h > hits[0])
    assert k > 0
    rec = Recorder(al)
    done = []
    monkeypatch.setenv("SEGALIGN_MAX_CHUNK_HITS", str(hits[0]))
    with pytest.raises(RuntimeError, match=rf"seed hits \(> {hits[0]}\)"):
        al.map_chunks(work, on_result=lambda i, r: done.append(i))
    assert len(rec.threads["seed"]) == k + 1 and rec.seeds_done == k
    assert len(rec.threads["extend"]) == k
    assert rec.finishing == 0 and done == list(range(len(done)))
    monkeypatch.delenv("SEGALIGN_MAX_CHUNK_HITS")
    assert_same(al.map_chunks(work), want)


def test_extension_error_leaves_no_finisher_work_running(monkeypatch):
    """An extension that raises while the finisher still works on the
    chunk before: map_chunks raises its error only once that work has
    ended, and finishes nothing after it."""
    monkeypatch.delenv("SEGALIGN_OVERLAP", raising=False)
    al, work = aligner("plain")
    rec = Recorder(al)
    failing = threading.Event()

    def finish_hook(k):
        if k == 1:
            assert failing.wait(10)
            time.sleep(0.02)

    def extend_hook(k):
        if k == 2:
            failing.set()
            raise ValueError("extension failed")

    rec.hooks = dict(finish=finish_hook, extend=extend_hook)
    with pytest.raises(ValueError, match="extension failed"):
        al.map_chunks(work, depth=4)
    assert rec.finishing == 0 and len(rec.threads["finish"]) == 2
    assert len(rec.threads["seed"]) == len(rec.threads["extend"]) == 3
