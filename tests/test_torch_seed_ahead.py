"""The native route's seeding stage: map_chunks seeds the next chunk on a
thread of its own while the calling thread extends the current one.

On the CPU at a tiny size (a few kb, 256-512 bp chunks, 10-12
chunk-strands): the overlapped map_chunks against its serial form
(SEGALIGN_OVERLAP=0) and against seed_and_filter chunk by chunk, which
tests/test_torch_pipeline.py holds to the JAX package; that the seeding
runs beside the extension, one chunk ahead and no further; and that a
seeding error raises at its chunk with no seeding left running."""

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
    """Wraps an aligner's seeder and _extend_seeded: which thread runs
    each call, and when each starts and ends, in call order (the seeder is
    called once a chunk-strand, in work order, and so is
    _extend_seeded)."""

    def __init__(self, al):
        self.lock = threading.Lock()
        self.seed_threads, self.extend_threads = [], []
        self.seeds_done = self.extends_started = 0
        self.active = 0            # seeding calls running now
        self.waiting = []          # seeded chunks not yet extended, at
        #                            each seeding call's start
        self._started = {}         # call index: Event, set at its start
        self.seed_hook = self.extend_hook = None
        seed, extend = al._seeder.seed, al._extend_seeded

        def seed_rec(*a, **kw):
            with self.lock:
                k = len(self.seed_threads)
                self.seed_threads.append(threading.get_ident())
                self.waiting.append(self.seeds_done - self.extends_started)
                self.active += 1
            self.seed_started(k).set()
            try:
                if self.seed_hook is not None:
                    self.seed_hook(k)
                return seed(*a, **kw)
            finally:
                with self.lock:
                    self.active -= 1
                    self.seeds_done += 1

        def extend_rec(s):
            with self.lock:
                k = len(self.extend_threads)
                self.extend_threads.append(threading.get_ident())
                self.extends_started += 1
            if self.extend_hook is not None:
                self.extend_hook(k)
            return extend(s)

        al._seeder.seed = seed_rec
        al._extend_seeded = extend_rec

    def seed_started(self, k) -> threading.Event:
        with self.lock:
            return self._started.setdefault(k, threading.Event())


def test_seeding_runs_beside_the_extension_one_chunk_ahead(monkeypatch):
    """Chunk k + 1's seeding starts, on a thread of its own, before chunk
    k's extension ends (each extension waits for it: a serial map_chunks
    would time out here); when a seeding starts, at most one seeded chunk
    waits for the dispatch thread."""
    monkeypatch.delenv("SEGALIGN_OVERLAP", raising=False)
    al, work = aligner("plain")
    want = al.map_chunks(work)
    rec = Recorder(al)
    overlapped = []

    def extend_hook(k):
        if k + 1 < len(work) and all(overlapped):
            overlapped.append(rec.seed_started(k + 1).wait(10))

    rec.extend_hook = extend_hook
    assert_same(al.map_chunks(work), want)
    me = threading.get_ident()
    assert len(rec.seed_threads) == len(rec.extend_threads) == len(work)
    assert set(rec.extend_threads) == {me}
    assert len(set(rec.seed_threads)) == 1 and me not in rec.seed_threads
    assert overlapped == [True] * (len(work) - 1)
    assert max(rec.waiting) <= 1 and rec.active == 0


def test_serial_form_seeds_on_the_calling_thread(monkeypatch):
    monkeypatch.setenv("SEGALIGN_OVERLAP", "0")
    al, work = aligner("plain")
    rec = Recorder(al)
    al.map_chunks(work)
    me = threading.get_ident()
    assert set(rec.seed_threads) == set(rec.extend_threads) == {me}
    assert rec.seeds_done == len(work)


def test_seeder_error_raises_at_its_chunk_and_stops_the_seeding(
        monkeypatch):
    """The hit ceiling (SEGALIGN_MAX_CHUNK_HITS) at a chunk-strand after
    the first: map_chunks raises it after extending the chunks before it,
    seeds nothing after it, and leaves no seeding running; the aligner
    then maps the same work as before."""
    monkeypatch.delenv("SEGALIGN_OVERLAP", raising=False)
    al, work = aligner("plain")
    want = al.map_chunks(work)
    hits = [r.num_hits for r in want]
    k = next(i for i, h in enumerate(hits) if h > hits[0])
    assert k > 0
    rec = Recorder(al)
    monkeypatch.setenv("SEGALIGN_MAX_CHUNK_HITS", str(hits[0]))
    with pytest.raises(RuntimeError, match=rf"seed hits \(> {hits[0]}\)"):
        al.map_chunks(work)
    assert rec.seeds_done == k + 1 and rec.extends_started == k
    assert rec.active == 0
    monkeypatch.delenv("SEGALIGN_MAX_CHUNK_HITS")
    assert_same(al.map_chunks(work), want)


def test_extension_error_waits_for_the_seeding_in_flight(monkeypatch):
    """An extension that raises while the next chunk is seeded: map_chunks
    raises its error only once that seeding has ended."""
    monkeypatch.delenv("SEGALIGN_OVERLAP", raising=False)
    al, work = aligner("plain")
    rec = Recorder(al)
    failing = threading.Event()

    def seed_hook(k):
        if k == 3:
            assert failing.wait(10)
            time.sleep(0.02)

    def extend_hook(k):
        if k == 2:
            failing.set()
            raise ValueError("extension failed")

    rec.seed_hook, rec.extend_hook = seed_hook, extend_hook
    with pytest.raises(ValueError, match="extension failed"):
        al.map_chunks(work)
    assert rec.active == 0 and rec.seeds_done == 4
    assert rec.extends_started == 3
