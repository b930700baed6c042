"""Per-chunk pipeline on one device: seeds -> hits -> extension ->
candidates -> HSPs.

Counterpart of segalign_tpu/pipeline/device.py DeviceAligner and its two
routes, chosen when the aligner is made. Both seed each chunk on the
device the same way (_seed_chunk: ops/seeding.py chunk_seeds, and a host
chain of lower bounds over the seeds' hit counts that cuts the logical hit
batches, _plan_limits) and expand each range of at most HBUF hits on the
device (ops/hits.py expand_hits); they differ in the extension engine:

  - native (the default): each program of HBUF hits is one device program
    (pipeline/program.py extend_program: the hits, the fused engine of
    ops/extend_fused.py, K1 on the sequences, then K4s, every survivor
    walked to its end in one launch, and its candidates appended to the
    chunk-strand's buffer on the device), on the card one replay of a CUDA
    graph captured once; a chunk-strand's candidates are deduped and
    compacted on the device (pack_candidates, on the card a graph of its
    own) into a block and a count that the finisher fetches: nothing
    between the plan and that fetch waits for the card. The host
    recomputes the entropy counts of the candidates that need them. The
    host seeder (native.ChunkSeeder, native/seeder.cpp) is not on this
    route: it is the check that the tests and chip_smoke.py hold the
    device's hits to.
  - device seeding (device_seeding=True, or SEGALIGN_DEVICE_SEEDING=1 when
    the caller passes None, read on each construction as the JAX aligner
    reads it; the name is the JAX package's): each range is extended by
    the same kernels at the same widths (ops/extend3.py
    extend_hits_windowed: K1 on the sequences, then K4s) with the entropy
    counts on, and its candidates compacted and fetched, the range's only
    wait for the card.

On both, the host finalizes entropy and dedups each logical hit batch with
the host code of ops/finalize.py and ops/dedup.py. In rm_mode (the repeat
masker) hits are restricted to a window of the reference, minus-strand
HSPs are remapped onto the forward strand, and the dedup is dedup_rm.

What the JAX aligner carries for the TPU and its remote compiles has no
counterpart, since none of it changes output: power-of-two program and
buffer classes, dummy programs, transient-compile retries and the compile
lock. Its fixed compaction width has one: the native route's candidate
buffers (CAND_ROWS, KEPT_ROWS), which spare the card a sync a program; a
chunk-strand whose candidates do not fit is extended again into larger
ones (the JAX package re-packs instead: it keeps every program's fields,
which the port lets go of). Every other device step runs eagerly on
`device`, a CPU device in tests and a CUDA device on the card.

Stage times, as in the JAX aligner: every chunk adds the host time of
its stages to STAGE_TOTALS (bench.py's serial breakdown reads it;
cleared by reset_stage_totals). Both routes' stages start with seeds
(chunk_seeds and its counts' fetch) and plan (_batch_ends). The native
route's go on with extend (a program each: its hit range written to the
device and the program run, on the card a graph replay; the first also
sets the chunk-strand's window and batch ends), pack (pack_candidates),
d2h (the count's and the candidates' fetch; a chunk-strand extended
again adds its stages to seeds, plan, extend and pack) and host_dedup
(_split_and_finalize); the device route's with extend
(_process_hit_range, whose fetch is part of it), nrange (1e-3 a hit
range: a count) and host_dedup. The JAX stage recompact has no
counterpart (the port extends again instead), nor has the device route's
separate d2h. Kernels run asynchronously, so a device stage's time is
its dispatch time unless SEGALIGN_SYNC=1, which synchronizes the device
before each device stage's clock stops. SEGALIGN_TIMING=1 prints each
chunk's stages to stderr. Both are read on every call. The stages add up
to the wall in the serial form of map_chunks only (SEGALIGN_OVERLAP=0):
otherwise d2h and host_dedup run on the finisher thread while the
dispatch thread's stages run.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..index.seed_table import build_seed_table
from ..native import check_chunk_hits, entropy_counts_host, get_lib
from ..ops.dedup import dedup_pairwise, dedup_rm
from ..ops.extend3 import extend_hits_windowed
from ..ops.finalize import finalize_candidates
from ..ops.hits import compact_mask, expand_hits
from ..ops.padding import pad_sequence
from ..ops.seeding import chunk_seeds
from .program import (DUMP, END, FIELDS, NO_WINDOW, Buffers, ProgramGraph,
                      extend_program, pack_candidates, program_hits)

DEFAULT_MAX_HITS = 4194304 * 16  # reference: MAX_HITS_PER_GB * gpu_mem_gb
# extension window widths: the first window of every hit (the default of
# DeviceAligner's `window`), and the windows of the hits that outrun it
# (results do not depend on either width)
FIRST_W = 512
CONT_W = 2048
PAD = max(FIRST_W, CONT_W)  # sequence padding that covers every window
# the native route's candidate buffers at first, in rows: a chunk-strand's
# candidates less each program's duplicates, the pack's kept rows, and its
# logical batches (on the benchmark's 4 Mbp pair, whose densest
# chunk-strand has hundreds of thousands of candidates, none passes
# them); they grow to twice the most a chunk-strand has needed, and a
# chunk-strand that passes one is extended again
CAND_ROWS = 1 << 15
KEPT_ROWS = 1 << 12
BATCHES = 64

# Cumulative host time of each stage over every chunk in this process, in
# seconds (module docstring); map_chunks' dispatch and finisher threads
# (and the farm's workers) add to it at once, hence the lock.
STAGE_TOTALS: dict = {}
_STAGE_LOCK = threading.Lock()
# While a list, every stage is also appended to it as (name, start, end)
# in time.time_ns() (the benchmark's profiled pass names the device's idle
# gaps by the stage the host was in); None otherwise.
STAGE_SPANS: Optional[list] = None


def reset_stage_totals():
    with _STAGE_LOCK:
        STAGE_TOTALS.clear()


class _StageTimer:
    """One chunk's stage times: each add goes to STAGE_TOTALS, and to the
    chunk's own line on stderr under SEGALIGN_TIMING=1."""

    def __init__(self):
        self.enabled = os.environ.get("SEGALIGN_TIMING", "") == "1"
        self.t = {}

    def add(self, name, dt):
        if self.enabled:
            self.t[name] = self.t.get(name, 0.0) + dt
        with _STAGE_LOCK:
            STAGE_TOTALS[name] = STAGE_TOTALS.get(name, 0.0) + dt
            if STAGE_SPANS is not None:
                end = time.time_ns()
                STAGE_SPANS.append((name, end - int(dt * 1e9), end))

    def dump(self, prefix):
        if self.enabled and self.t:
            parts = " ".join(f"{k}={v*1000:.1f}ms"
                             for k, v in sorted(self.t.items()))
            print(f"[timing] {prefix}: {parts}", file=sys.stderr, flush=True)


def on_device(device: torch.device):
    """A context in which `device` is the thread's current CUDA device (a
    kernel launches only onto a stream of the current device, and the
    current device is per thread); nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclass
class ChunkResult:
    hsps: np.ndarray       # (n, 4) int64: ref_start, query_start, len, score
    num_hits: int
    num_seeds: int
    # logical hit batches (the reference's max_hits batching) the chunk's
    # hits were cut into; 0 without hits
    num_batches: int = 0
    # the times its candidates passed the native route's buffers and it
    # was extended again
    reextended: int = 0


@dataclass
class PendingChunk:
    """One chunk-strand whose candidates sit on the device, not yet
    fetched: the unit that map_chunks hands to its finisher thread."""
    chunk_start: int
    chunk_end: int
    rev: bool
    num_seeds: int
    num_hits: int
    # pack_candidates' block, (kept_rows + DUMP, 9) int32 on the device: orig
    # hit index, rs, qs, length, total, counts[4] of the kept rows first,
    # in ascending hit order, and its count (2,) int64: kept rows and the
    # rows the programs appended; None when the chunk had no hits
    out: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]
    # logical hit-batch boundaries (the reference's max_hits batching) as
    # end offsets into the hit stream
    seg_ends: np.ndarray
    window: Optional[Tuple[int, int]] = None
    # the candidate buffer's rows when the programs ran
    cand_rows: int = 0


@dataclass
class SeededChunk:
    """One chunk-strand seeded on the device, not yet extended (_seed_chunk):
    its seed slots' hit counts and where their hits lie, from which
    expand_hits makes any range of its hit stream. Without hits cum,
    starts and qpos are None."""
    chunk_start: int
    chunk_end: int
    rev: bool
    num_seeds: int
    num_hits: int
    cum: Optional[torch.Tensor]     # (S,) int32: inclusive hit cumsum
    starts: Optional[torch.Tensor]  # (S,) int32: bucket starts
    qpos: Optional[torch.Tensor]    # (S,) int32: query positions
    # logical hit-batch ends into the hit stream (as PendingChunk's; every
    # hit counts, the RM window's or not)
    seg_ends: np.ndarray
    window: Optional[Tuple[int, int]]
    tm: _StageTimer


def _plan_limits(cum: torch.Tensor, num_hits: int, max_hits: int,
                 num_iter: int):
    """The host chain of lower bounds of the reference's iteration
    batching (seed_filter.cu:718-741), one device sync a step: returns the
    seed positions and hit offsets of the first num_iter - 1 limits."""
    poss, vals = [], []
    limit = min(num_hits, max_hits)
    for _ in range(num_iter - 1):
        # the last seed whose cumulative hit count is below the limit, and
        # that count (0 before the first seed)
        pos = torch.searchsorted(
            cum, torch.tensor([limit], dtype=cum.dtype,
                              device=cum.device)) - 1
        val = torch.where(pos >= 0, cum[pos.clamp(min=0)].long(), 0)
        pos, val = torch.cat([pos, val]).tolist()
        poss.append(pos)
        vals.append(val)
        limit = min(val + max_hits, num_hits)
    return poss, vals


def _batch_limits(cum: torch.Tensor, num_hits: int, max_hits: int):
    """_plan_limits over as many steps as the reference's batching takes:
    the last seed slot and the end offset into the hit stream of every
    logical hit batch but the last."""
    num_iter = 2 if num_hits < max_hits else num_hits // max_hits + 2
    return _plan_limits(cum, num_hits, max_hits, num_iter)


def _batch_ends(cum: torch.Tensor, num_hits: int, max_hits: int) -> list:
    """End offsets into the hit stream of the logical hit batches: the
    chain of _plan_limits and a last batch that ends at num_hits, dropped
    when its seed position repeats the chain's last one."""
    poss, vals = _batch_limits(cum, num_hits, max_hits)
    return _ends_of_limits(poss, vals, cum.shape[0], num_hits)


def _ends_of_limits(poss: list, vals: list, num_slots: int,
                    num_hits: int) -> list:
    """_batch_ends from _batch_limits' (poss, vals) over num_slots seed
    slots."""
    limit_pos = poss + [num_slots - 1]
    hit_bound = vals + [num_hits]
    if limit_pos[-1] == limit_pos[-2]:
        hit_bound.pop()
    return hit_bound


def _range_hits(pos_table, cum, starts, qpos, g0: int, g1: int,
                seed_size: int, window):
    """Hits [g0, g1) as (ref_loc, query_loc, valid): valid only where the
    reference position lies in the RM window, when one is given."""
    ref_loc, query_loc, valid = expand_hits(
        cum, starts, qpos, pos_table, g0, g1, seed_size, HBUF=g1 - g0)
    if window is not None:
        valid &= (ref_loc >= window[0]) & (ref_loc <= window[1])
    return ref_loc, query_loc, valid


def _hit_ranges(seg_ends, HBUF: int) -> list:
    """The device route's hit ranges: (g0, g1) of at most HBUF hits, cut
    at every logical batch end of seg_ends; a list a batch."""
    out, h0 = [], 0
    for h1 in seg_ends:
        out.append([(g0, min(g0 + HBUF, h1)) for g0 in range(h0, h1, HBUF)])
        h0 = max(h0, h1)
    return out


def _process_hit_range(ref_pad, query_pad, pos_table, cum, starts, qpos,
                       sub, g0: int, g1: int, ref_len: int, query_len: int,
                       xdrop: int, hspthresh: int, seed_size: int, window,
                       *, pad: int, W: int, W_CONT: int):
    """Expand hits [g0, g1) (_range_hits), extend them (a W-wide first
    window, W_CONT-wide continuations), and fetch the candidates: an
    (n, 8) int64 host array of rs, qs, length, total and counts[4], in hit
    order."""
    ref_loc, query_loc, valid = _range_hits(pos_table, cum, starts, qpos, g0,
                                            g1, seed_size, window)
    res = extend_hits_windowed(ref_pad, query_pad, ref_loc, query_loc, valid,
                               sub, xdrop, hspthresh, ref_len, query_len,
                               pad=pad, W=W, W_CONT=W_CONT)
    n, rs, qs, ln, total, counts = compact_mask(
        res["candidate"], res["rs"], res["qs"], res["length"], res["total"],
        res["counts"])
    n = int(n)
    return torch.cat([rs[:n, None], qs[:n, None], ln[:n, None],
                      total[:n, None], counts[:n]],
                     dim=1).cpu().numpy().astype(np.int64)


def finalize_batch(rs, qs, ln, total, counts, *, hspthresh: int,
                   noentropy: bool, rm_mode: bool, rev: bool, ref_len: int):
    """Entropy finalize and dedup of one logical hit batch's candidates,
    given their match counts; an (n, 4) int64 array or None."""
    accepted, scores = finalize_candidates(rs, qs, ln, total, counts,
                                           hspthresh, noentropy)
    if not accepted.any():
        return None
    rs, qs, ln, sc = (rs[accepted], qs[accepted], ln[accepted],
                      scores[accepted])
    if rm_mode and rev:
        # minus-strand remap onto forward-strand coordinates (the
        # reference repeat masker's seed_filter.cu:705-709)
        qs = ref_len - 1 - (qs + ln)
    rs, qs, ln, sc = (dedup_rm if rm_mode else dedup_pairwise)(rs, qs, ln, sc)
    return np.stack([rs, qs, ln, sc], axis=1)


class DeviceAligner:
    """Device-resident state for one (reference block, query block) pair,
    and the per-chunk seed-filter-extend calls on it."""

    def __init__(self, *, shape_pos, seed_size, transition, step, sub_mat,
                 xdrop, hspthresh, noentropy, chunk_size, device,
                 max_hits: int = DEFAULT_MAX_HITS, HBUF: int = 1 << 17,
                 rm_mode: bool = False,
                 device_seeding: Optional[bool] = None,
                 window: int = FIRST_W):
        if window <= 0 or window % 16 or window > PAD:
            raise ValueError(f"window={window} must be a multiple of 16 in "
                             f"(0, {PAD}] (the sequence padding)")
        self.shape_pos = tuple(shape_pos)
        self.seed_size = seed_size
        self.kmer_size = len(shape_pos)
        self.transition = transition
        self.step = step
        self.xdrop = xdrop
        self.hspthresh = hspthresh
        self.noentropy = noentropy
        self.chunk_size = chunk_size
        self.max_hits = max_hits
        # hits per extension program (native route) or per expanded hit
        # range (device route): bounds the device memory of a range's
        # anchors and states
        self.HBUF = HBUF
        self.rm_mode = rm_mode
        if device_seeding is None:
            device_seeding = os.environ.get("SEGALIGN_DEVICE_SEEDING") == "1"
        self.device_seeding = device_seeding
        # first-window width of both routes' extension (outputs do not
        # depend on it)
        self.window = window
        self.device = torch.device(device)
        # the native route's programs (_program): their buffers, made at
        # the first chunk-strand, and on the card a graph per query strand,
        # its capture stream and memory pool; the lock keeps one
        # chunk-strand at a time on them (the finisher's extend-again
        # against the next dispatch)
        self._buf: Optional[Buffers] = None
        self._cand_rows, self._kept_rows = CAND_ROWS, KEPT_ROWS
        self._graphs: dict = {}
        self._stream = self._pool = None
        self._lock = threading.Lock()
        self.sub = torch.as_tensor(
            np.asarray(sub_mat, np.int32).reshape(-1)).to(self.device)
        # the host code of both routes (seed table, dedup, entropy counts)
        # runs in the native library: build and load it now, so that a
        # failure raises here
        get_lib()
        self.ref_len = 0
        self.q_len = 0
        self.drop_ref()

    def _upload(self, codes: np.ndarray, right_pad: int = 0
                ) -> torch.Tensor:
        return torch.from_numpy(pad_sequence(codes, PAD, right_pad)).to(
            self.device)

    def drop_ref(self):
        """Let go of the reference block's state: the padded reference, the
        index and position tables on the device, and the host's copies."""
        self.ref_pad = self.index_table = self.pos_table = None
        self._ref_host = self._host_tables = None
        self._drop_graphs()   # they read the old block

    def set_ref(self, ref_codes: np.ndarray, tables=None):
        """tables: an optional precomputed (index_table, pos_table). The
        old block's state goes first, so that the device never holds two
        blocks (the position table is 4 bytes a base)."""
        self.drop_ref()
        self.ref_len = len(ref_codes)
        self._ref_host = np.ascontiguousarray(ref_codes, np.uint8)
        self.ref_pad = self._upload(ref_codes)
        if tables is None:
            tables = build_seed_table(ref_codes, self.step, self.shape_pos,
                                      self.seed_size, self.kmer_size)
        self._host_tables = tuple(np.ascontiguousarray(t, np.int32)
                                  for t in tables)
        index_table, pos_table = self._host_tables
        self.index_table = torch.from_numpy(index_table).to(self.device)
        # expand_hits indexes the position table even with no hits
        self.pos_table = torch.from_numpy(
            pos_table if len(pos_table) else np.zeros(1, np.int32)).to(
                self.device)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        self.q_len = len(fw_codes)
        # chunk_seeds reads chunk_size + seed_size bytes from a chunk start
        right = self.chunk_size + self.seed_size + 1
        self.q_fw = self._upload(fw_codes, right)
        self.q_rc = self._upload(rc_codes, right)
        self._q_fw_host = np.ascontiguousarray(fw_codes, np.uint8)
        self._q_rc_host = np.ascontiguousarray(rc_codes, np.uint8)
        self._drop_graphs()   # they read the old query

    def map_chunks(self, work, depth: int = 4, on_result=None
                   ) -> List[ChunkResult]:
        """Process chunks in order; results in work order.

        The native route runs two stages on two threads: this thread seeds
        and extends each chunk on the device (dispatch_chunk), and a
        finisher thread fetches each chunk's candidates and runs the host
        finalize and dedup; at most `depth` dispatched-but-unread chunks
        wait. SEGALIGN_OVERLAP=0 (read on every call) runs the serial form
        instead: this thread also finishes each chunk, once `depth` newer
        ones are dispatched. The device route runs chunk by chunk, as in
        the JAX package. on_result(index, ChunkResult), when given, fires
        as each chunk finishes, in work order. An error of any stage
        raises here at its chunk's turn, and no stage's work runs on after
        this returns or raises."""
        if self.device_seeding:
            results = []
            for i, w in enumerate(work):
                results.append(self.seed_and_filter(
                    w.chunk_start, w.chunk_end, w.rev, window=w.window))
                if on_result is not None:
                    on_result(i, results[-1])
            return results
        results = []
        if os.environ.get("SEGALIGN_OVERLAP", "") == "0":
            pend: deque = deque()
            for i, w in enumerate(work):
                pend.append((i, self.dispatch_chunk(
                    w.chunk_start, w.chunk_end, w.rev, window=w.window)))
                while pend and (len(pend) > depth or i == len(work) - 1):
                    j, p = pend.popleft()
                    results.append(self.finish_chunk(p))
                    if on_result is not None:
                        on_result(j, results[-1])
            return results
        futs: deque = deque()

        def drain():
            j, f = futs.popleft()
            r = f.result()
            if on_result is not None:
                on_result(j, r)
            results.append(r)

        # leaving the block waits for the finisher's work in flight
        with ThreadPoolExecutor(1) as ex:
            for i, w in enumerate(work):
                pend = self.dispatch_chunk(w.chunk_start, w.chunk_end, w.rev,
                                           window=w.window)
                futs.append((i, ex.submit(self._finish_on_device, pend)))
                while len(futs) > depth:
                    drain()
            while futs:
                drain()
        return results

    def _finish_on_device(self, p: PendingChunk) -> ChunkResult:
        # the current CUDA device is per thread: name it in the finisher
        with on_device(self.device):
            return self.finish_chunk(p)

    def seed_and_filter(self, chunk_start: int, chunk_end: int, rev: bool,
                        window: Optional[Tuple[int, int]] = None
                        ) -> ChunkResult:
        """The HSPs of one chunk-strand. window: the RM window (lo, hi) of
        reference positions a hit must lie in, or None."""
        if self.device_seeding:
            return self._seed_and_filter_device(chunk_start, chunk_end, rev,
                                                window)
        return self.finish_chunk(
            self.dispatch_chunk(chunk_start, chunk_end, rev, window))

    def dispatch_chunk(self, chunk_start: int, chunk_end: int, rev: bool,
                       window: Optional[Tuple[int, int]] = None
                       ) -> PendingChunk:
        """Seeding, hit expansion, extension and candidate compaction of one
        chunk-strand on the device (native route): _seed_chunk into the
        programs' buffers, then _extend_seeded."""
        with self._lock:
            return self._extend_seeded(self._seed_chunk(
                chunk_start, chunk_end, rev, window, into=self._buffers()))

    def _seed_chunk(self, chunk_start: int, chunk_end: int, rev: bool,
                    window: Optional[Tuple[int, int]] = None,
                    into: Optional[Buffers] = None) -> SeededChunk:
        """Both routes' first half of a chunk-strand: its seeds and their
        hit counts on the device (chunk_seeds; into the seed slots of
        `into` when given), the hit ceiling, and the logical batch ends over
        its whole hit stream (_batch_ends)."""
        tm = _StageTimer()
        t0 = time.time()
        q = self.q_rc if rev else self.q_fw
        _, qpos, _, starts, cum, stats = chunk_seeds(
            q, self.index_table, chunk_start, chunk_end - chunk_start,
            CHUNK=self.chunk_size, seed_size=self.seed_size,
            shape_pos=self.shape_pos, transition=self.transition, pad=PAD,
            out=None if into is None else (into.qpos, into.starts,
                                            into.cum))
        num_seeds, num_hits = stats.tolist()   # no seed, no hit
        if num_seeds:
            check_chunk_hits(num_hits, chunk_start, int32_cum=True)
            tm.add("seeds", time.time() - t0)
        if num_hits == 0:
            return SeededChunk(chunk_start, chunk_end, rev, num_seeds, 0,
                               None, None, None, np.zeros(0, np.int64),
                               window, tm)
        t0 = time.time()
        seg_ends = np.asarray(_batch_ends(cum, num_hits, self.max_hits),
                              np.int64)
        tm.add("plan", time.time() - t0)
        return SeededChunk(chunk_start, chunk_end, rev, num_seeds, num_hits,
                           cum, starts, qpos, seg_ends, window, tm)

    def _program_hits(self, s: SeededChunk, g0: int):
        """The hits that the program at g0 of a seeded chunk-strand extends,
        on the device: (ref_loc, query_loc, orig), each row's anchors and
        its index in the chunk-strand's hit stream, for hits [g0, g0 +
        HBUF) in order; with an RM window only those whose reference
        position lies in it. The rows program_hits makes valid, cut to
        them: the check of the card's seeding (the route masks, and cuts
        nothing)."""
        lo, hi = s.window or NO_WINDOW
        ref_loc, query_loc, orig, valid = program_hits(
            self.pos_table, s.cum, s.starts, s.qpos, g0,
            min(g0 + self.HBUF, s.num_hits), lo, hi, HBUF=self.HBUF,
            seed_size=self.seed_size)
        keep = torch.nonzero(valid).squeeze(1)
        return ref_loc[keep], query_loc[keep], orig[keep]

    def _buffers(self) -> Buffers:
        """The programs' buffers, made at the first chunk-strand, with a
        candidate buffer of self._cand_rows rows; a new one drops the
        graphs, which read the old."""
        if self._buf is None:
            nvar = 1 + self.kmer_size if self.transition else 1
            self._buf = Buffers(self.chunk_size * nvar, BATCHES,
                                self._cand_rows, self.device)
        elif self._buf.cand_rows < self._cand_rows:
            self._buf.rows = torch.zeros(
                (self._cand_rows + DUMP, FIELDS), dtype=torch.int32,
                device=self.device)
            self._drop_graphs()
        return self._buf

    def _drop_graphs(self):
        """Let go of the programs' graphs and of their memory pool: a pool
        whose graphs have all gone takes no new capture."""
        self._graphs = {}
        self._pool = None

    def _program_fn(self, rev: bool, rows: Optional[int] = None):
        """extend_program on the buffers for a chunk-strand of strand
        `rev`, over `rows` rows (HBUF when None): the function a graph is
        captured from (which the checks run eagerly beside the replays),
        and on the CPU the native route's program."""
        return functools.partial(
            extend_program, self.ref_pad, self.q_rc if rev else self.q_fw,
            self.pos_table, self.sub, self._buf, HBUF=rows or self.HBUF,
            seed_size=self.seed_size, xdrop=self.xdrop,
            hspthresh=self.hspthresh, ref_len=self.ref_len,
            query_len=self.q_len, pad=PAD, W=self.window, W_CONT=CONT_W)

    def _program(self, rev: bool):
        """What runs one program of a chunk-strand of strand `rev`, called
        with the program's hit count: on the card the replay of its CUDA
        graph of HBUF rows, captured at the first program after the
        buffers, the reference block or the query changed (a capture that
        fails raises); on the CPU _program_fn over the program's hits
        only, since there the kernels' plain versions pay for every row,
        and the rows past a program's hits are never candidates."""
        if self.device.type != "cuda":
            return lambda rows: self._program_fn(rev, rows)()
        graph = self._graphs.get(rev)
        if graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = self._graphs[rev] = self._capture(self._program_fn(rev),
                                                      self._pool)
        return lambda rows: graph.replay()

    def _pack(self):
        """pack_candidates on the buffers: on the CPU the function; on the
        card the replay of its graph (a memory pool of its own; captured
        again when the kept rows grow) and copies of its block and count,
        which the next chunk-strand's replay overwrites."""
        pack = functools.partial(pack_candidates, self._buf, self._kept_rows)
        if self.device.type != "cuda":
            return pack()
        graph = self._graphs.get("pack")
        if graph is None or \
                graph.outputs[0].shape[0] != self._kept_rows + DUMP:
            graph = self._graphs["pack"] = self._capture(pack, None)
        return tuple(t.clone() for t in graph.replay())

    def _capture(self, run, pool) -> ProgramGraph:
        """`run` captured on the aligner's capture stream into `pool`."""
        _build.kernels()   # the kernels' library is loaded outside
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with on_device(self.device):
            return ProgramGraph(run, self._stream, pool)

    def _extend_seeded(self, s: SeededChunk) -> PendingChunk:
        """The native route's second half of a chunk-strand seeded into the
        programs' buffers: its programs (_dispatch_rows) and the pack of
        their candidates, on the calling thread's device; nothing here
        waits for the card."""
        if s.num_hits == 0:
            return PendingChunk(s.chunk_start, s.chunk_end, s.rev,
                                s.num_seeds, 0, None, None, s.seg_ends,
                                s.window)
        self._dispatch_rows(s)
        t0 = time.time()
        out, counts = self._pack()
        self._sync()
        s.tm.add("pack", time.time() - t0)
        s.tm.dump(f"dispatch {s.chunk_start}:{s.chunk_end} rev={s.rev} "
                  f"hits={s.num_hits}")
        return PendingChunk(s.chunk_start, s.chunk_end, s.rev, s.num_seeds,
                            s.num_hits, out, counts, s.seg_ends, s.window,
                            self._buf.cand_rows)

    def _sync(self):
        """Under SEGALIGN_SYNC=1, wait for the device's work (CUDA only)."""
        if self.device.type == "cuda" and \
                os.environ.get("SEGALIGN_SYNC", "") == "1":
            torch.cuda.synchronize(self.device)

    def _dispatch_rows(self, s: SeededChunk) -> None:
        """The programs of a chunk-strand seeded into the buffers, one per
        span of HBUF hits (_program), their candidates appended to the
        buffers' candidate rows: the chunk-strand's window and batch ends
        (its batches grow the buffer's room for them when they pass it)
        and a zero count written to the device, then each program's hit
        range and the program. Nothing here reads a device value."""
        buf = self._buf
        t0 = time.time()
        if len(s.seg_ends) > buf.seg_ends.shape[0]:
            buf.seg_ends = torch.full(
                (1 << (len(s.seg_ends) - 1).bit_length(),), END,
                dtype=torch.int64, device=self.device)
            self._drop_graphs()
        ends = np.full(buf.seg_ends.shape[0], END, np.int64)
        ends[:len(s.seg_ends)] = s.seg_ends
        ends = torch.from_numpy(ends)
        if self.device.type == "cuda":
            ends = ends.pin_memory()   # a copy that does not wait
        buf.seg_ends.copy_(ends, non_blocking=True)
        lo, hi = s.window or NO_WINDOW
        buf.lo.fill_(lo)
        buf.hi.fill_(hi)
        buf.n.zero_()
        run = self._program(s.rev)
        for g0 in range(0, s.num_hits, self.HBUF):
            g1 = min(g0 + self.HBUF, s.num_hits)
            buf.g0.fill_(g0)
            buf.g1.fill_(g1)
            run(g1 - g0)
            self._sync()
            s.tm.add("extend", time.time() - t0)
            t0 = time.time()

    def _grow(self, n: int, kept: int, cand_rows: int):
        """The buffers' rule (the finisher's, which alone sees the counts):
        room for twice the most rows a chunk-strand has appended and kept
        so far, which the next dispatch takes (_buffers). Of a pack whose
        candidates passed its buffer the kept rows are scaled up by the
        share of them it saw."""
        if n > cand_rows:
            kept = -(-kept * n // max(cand_rows, 1))
        self._cand_rows = max(self._cand_rows, 2 * n)
        self._kept_rows = max(self._kept_rows, 2 * kept)

    def _extend_again(self, p: PendingChunk, n: int, kept: int
                      ) -> PendingChunk:
        """A dispatched chunk-strand whose n candidate rows or `kept` kept
        rows passed the buffers, seeded and extended again once the
        buffers have grown (_grow; the finisher's, which waits for the
        dispatch thread's chunk-strand in flight)."""
        self._grow(n, kept, p.cand_rows)
        with self._lock:
            return self._extend_seeded(self._seed_chunk(
                p.chunk_start, p.chunk_end, p.rev, p.window,
                into=self._buffers()))

    def finish_chunk(self, p: PendingChunk) -> ChunkResult:
        """Fetch a dispatched chunk's candidates; split them into logical
        batches; finalize entropy and dedup on the host."""
        nb = len(p.seg_ends)
        empty = np.zeros((0, 4), np.int64)
        if p.out is None:
            return ChunkResult(empty, p.num_hits, p.num_seeds, nb)
        tm = _StageTimer()
        t0 = time.time()
        kept, n = p.counts.tolist()
        again = 0
        while n > p.cand_rows or kept > p.out.shape[0] - DUMP:
            p = self._extend_again(p, n, kept)
            kept, n = p.counts.tolist()
            again += 1
        self._grow(n, kept, p.cand_rows)
        allrows = p.out[:kept].cpu().numpy().astype(np.int64)
        tm.add("d2h", time.time() - t0)
        t0 = time.time()
        hsps = self._split_and_finalize(allrows, p) if kept else empty
        tm.add("host_dedup", time.time() - t0)
        tm.dump(f"finish {p.chunk_start}:{p.chunk_end} rev={p.rev} "
                f"cand={kept} again={again}")
        return ChunkResult(hsps, p.num_hits, p.num_seeds, nb, again)

    def _split_and_finalize(self, allrows: np.ndarray,
                            p: PendingChunk) -> np.ndarray:
        """Logical-batch split (the reference's max_hits boundaries), then
        entropy finalize and dedup per batch."""
        seg = np.searchsorted(p.seg_ends, allrows[:, 0], side="right")
        all_out: List[np.ndarray] = []
        for s in np.unique(seg):
            r = allrows[seg == s]
            out_arr = self._finalize_batch(r[:, 1], r[:, 2], r[:, 3],
                                           r[:, 4], p.rev, counts=None)
            if out_arr is not None:
                all_out.append(out_arr)
        return (np.concatenate(all_out, axis=0) if all_out
                else np.zeros((0, 4), np.int64))

    def _finalize_batch(self, rs, qs, ln, total, rev: bool,
                        counts: Optional[np.ndarray]):
        """Entropy finalize and dedup of one logical hit batch; an (n, 4)
        int64 array or None.

        counts: the device's match counts (device route), or None (native
        route): that extension skips the counts; they are a function of the
        final extent (oracle/scan_spec.py), so the host recomputes them for
        the candidates in the entropy band only (rows outside it have
        entropy 1 and never read counts)."""
        if counts is None:
            counts = np.zeros((len(rs), 4), np.int64)
            if not self.noentropy:
                band = ((total >= self.hspthresh)
                        & (total <= 3 * self.hspthresh))
                if band.any():
                    q = self._q_rc_host if rev else self._q_fw_host
                    counts[band] = entropy_counts_host(
                        self._ref_host, q, rs[band], qs[band], ln[band])
        return finalize_batch(
            rs, qs, ln, total, counts, hspthresh=self.hspthresh,
            noentropy=self.noentropy, rm_mode=self.rm_mode, rev=rev,
            ref_len=self.ref_len)

    def _seed_and_filter_device(self, chunk_start: int, chunk_end: int,
                                rev: bool,
                                window: Optional[Tuple[int, int]]
                                ) -> ChunkResult:
        """Device seeding and batch planning (_seed_chunk), hit expansion
        and windowed extension of one chunk-strand; host finalize and dedup
        per logical batch."""
        empty = np.zeros((0, 4), np.int64)
        s = self._seed_chunk(chunk_start, chunk_end, rev, window)
        if s.num_hits == 0:
            return ChunkResult(empty, 0, s.num_seeds)
        q = self.q_rc if rev else self.q_fw
        ends = s.seg_ends.tolist()
        all_out: List[np.ndarray] = []
        for ranges in _hit_ranges(ends, self.HBUF):
            if not ranges:
                continue
            parts = []
            for g0, g1 in ranges:
                t0 = time.time()
                parts.append(_process_hit_range(
                    self.ref_pad, q, self.pos_table, s.cum, s.starts, s.qpos,
                    self.sub, g0, g1, self.ref_len, self.q_len, self.xdrop,
                    self.hspthresh, self.seed_size, window, pad=PAD,
                    W=self.window, W_CONT=CONT_W))
                s.tm.add("extend", time.time() - t0)
                s.tm.add("nrange", 1e-3)
            t0 = time.time()
            rows = np.concatenate(parts)
            out = self._finalize_batch(rows[:, 0], rows[:, 1], rows[:, 2],
                                       rows[:, 3], rev, counts=rows[:, 4:8])
            if out is not None:
                all_out.append(out)
            s.tm.add("host_dedup", time.time() - t0)
        hsps = np.concatenate(all_out) if all_out else empty
        s.tm.dump(f"chunk {chunk_start}:{chunk_end} rev={rev} "
                  f"hits={s.num_hits}")
        return ChunkResult(hsps, s.num_hits, s.num_seeds, len(ends))
