"""Per-chunk pipeline on one device: seeds -> hits -> extension ->
candidates -> HSPs.

Counterpart of segalign_tpu/pipeline/device.py DeviceAligner and its two
seeding routes, chosen when the aligner is made:

  - native (the default): the host seeds each chunk with the native
    seeder (native/seeder.cpp; in map_chunks on a thread of its own, one
    chunk ahead of the device); the device extends the
    hits in programs of at most HBUF rows (ops/extend_fused.py), keeps
    each program's candidate rows only (_program_candidates), and compacts
    and dedups them (_pack_compact); the host recomputes the entropy
    counts of the candidates that need them.
  - device seeding (device_seeding=True, or SEGALIGN_DEVICE_SEEDING=1 when
    the caller passes None, read on each construction as the JAX aligner
    reads it): the device seeds each chunk
    (ops/seeding.py); a host chain of lower bounds over the seeds' hit
    counts cuts the logical hit batches (_plan_limits); each range of at
    most HBUF hits is expanded (ops/hits.py), extended by the host-stepped
    windowed engine (ops/extend3.py extend_hits_windowed, whose window step
    is K5, ops/window_scan_wide.py) with the entropy counts on, and its
    candidates compacted and fetched.

On both, the host finalizes entropy and dedups each logical hit batch with
the host code of ops/finalize.py and ops/dedup.py. In rm_mode (the repeat
masker) hits are restricted to a window of the reference, minus-strand
HSPs are remapped onto the forward strand, and the dedup is dedup_rm.

What the JAX aligner carries for the TPU and its remote compiles has no
counterpart, since none of it changes output: power-of-two program and
buffer classes, dummy programs, the fixed compaction width and its
escalation, transient-compile retries and the compile lock. Every device
step here runs eagerly on `device`, a CPU device in tests and a CUDA
device on the card.

Stage times, as in the JAX aligner: every chunk adds the host time of its
stages to STAGE_TOTALS (bench.py's serial breakdown reads it; cleared by
reset_stage_totals). The native route's stages are seeds (the native
seeder), mask (the RM window), h2d (the tile checks and the anchors'
upload), extend (extend_fields_program), pack (_pack_compact), d2h (the
candidates' fetch) and host_dedup (_split_and_finalize); the device
route's are seeds (chunk_seeds), plan (_batch_ends), extend
(_process_hit_range, whose fetch is part of it), nrange (1e-3 a hit range:
a count) and host_dedup. The JAX stage recompact has no counterpart (it
re-packs the fixed compaction width, which the port does not have), nor
has the device route's separate d2h. Kernels run asynchronously, so a
device stage's time is its dispatch time unless SEGALIGN_SYNC=1, which
synchronizes the device before each device stage's clock stops.
SEGALIGN_TIMING=1 prints each chunk's stages to stderr. Both are read on
every call. The stages add up to the wall in the serial form of
map_chunks only (SEGALIGN_OVERLAP=0): otherwise seeds and mask run on the
seeding thread while the dispatch thread's stages run.
"""

from __future__ import annotations

import contextlib
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

from ..index.seed_table import build_seed_table
from ..native import (ChunkSeeder, check_chunk_hits, entropy_counts_host,
                      get_lib)
from ..ops.dedup import dedup_pairwise, dedup_rm
from ..ops.extend3 import extend_hits_windowed
from ..ops.extend_fused import Q_TILE, R_TILE, extend_fields_program
from ..ops.finalize import finalize_candidates
from ..ops.gather import tile_spans_ok
from ..ops.hits import compact_mask, expand_hits
from ..ops.padding import pad_sequence
from ..ops.seeding import chunk_seeds

DEFAULT_MAX_HITS = 4194304 * 16  # reference: MAX_HITS_PER_GB * gpu_mem_gb
# extension window widths: the first window of every hit (the default of
# DeviceAligner's `window`), and the windows of the hits that outrun it
# (results do not depend on either width)
FIRST_W = 512
CONT_W = 2048
PAD = max(FIRST_W, CONT_W)  # sequence padding that covers every window

# Cumulative host time of each stage over every chunk in this process, in
# seconds (module docstring); map_chunks' seeding, dispatch and finisher
# threads add to it at once, hence the lock.
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


@dataclass
class PendingChunk:
    """One chunk-strand whose candidates sit on the device, not yet
    fetched: the unit that map_chunks hands to its finisher thread."""
    chunk_start: int
    chunk_end: int
    rev: bool
    num_seeds: int
    num_hits: int
    # (n, 9) int32 on the device: orig hit index, rs, qs, length, total,
    # counts[4], in ascending hit order; None when the chunk had no hits
    out: Optional[torch.Tensor]
    # logical hit-batch boundaries (the reference's max_hits batching) as
    # end offsets into the hit stream
    seg_ends: np.ndarray


@dataclass
class SeededChunk:
    """One chunk-strand's hits on the host, seeded and kept to the RM
    window, not yet extended: what the native route's seeding stage hands
    to the dispatch thread. No hits to extend: ref_loc is empty."""
    chunk_start: int
    chunk_end: int
    rev: bool
    num_seeds: int
    num_hits: int
    ref_loc: np.ndarray    # (n,) int32
    query_loc: np.ndarray  # (n,) int32
    seg_ends: np.ndarray   # as PendingChunk's, over the kept hits
    tm: _StageTimer


def _program_candidates(fin: dict, g0: int) -> dict:
    """One extension program's candidate rows only, as soon as the program
    is extended: orig (g0 + row), rs, qs, length, total and counts, with
    candidate all true. The per-hit tensors go, so a chunk-strand's device
    memory grows with its candidates, not with its hits."""
    sel = torch.nonzero(fin["candidate"]).squeeze(1)
    out = {k: fin[k][sel] for k in ("candidate", "rs", "qs", "length",
                                     "total", "counts")}
    out["orig"] = g0 + sel
    return out


def _pack_compact(fins, seg_ends: torch.Tensor) -> torch.Tensor:
    """Candidates of all of a chunk-strand's programs as one (n, 9) int32
    block in ascending hit order, with exact duplicates removed.

    fins: the programs' fields in ascending hit order, each cut to its
    candidate rows by _program_candidates (the JAX package packs every
    row of every program; that keeps the same rows in the same order:
    the programs' rows stay in ascending orig, a non-candidate only ever
    sorts after every candidate, and the dedup compares live neighbours
    only, so the kept rows and their order do not depend on whether the
    non-candidates are there).

    A candidate is dropped when another candidate of the same logical hit
    batch has the same extent (rs, qs, length). Identical extents have
    identical totals and counts, so the host's entropy finalize and
    containment dedup give the same HSPs with one copy as with many (see
    segalign_tpu/pipeline/device.py _pack_compact). Candidates are sorted
    stably on the int64 key (rs << 31) | qs, non-candidates after them all,
    and neighbours equal on the key, the length and the batch are
    duplicates. rs and qs are int32 positions, so the key holds any block;
    the JAX key, rs plus 2^30 for non-candidates, drops every candidate at
    rs >= 2^30, which the repeat masker's block (1 Gbp and its neighbours'
    overlap, a fifth of the genome) passes on any genome over 1.1 Gbp."""
    cat = lambda k: torch.cat([f[k] for f in fins])
    cand, orig = cat("candidate"), cat("orig")
    rs, qs, ln = cat("rs"), cat("qs"), cat("length")
    seg = torch.searchsorted(seg_ends, orig, right=True)
    key, order = torch.sort(
        torch.where(cand, (rs.long() << 31) | qs.long(),
                    torch.iinfo(torch.int64).max), stable=True)
    s_ln, s_seg = ln[order], seg[order]
    live = cand[order]
    dup = ((key[1:] == key[:-1]) & (s_ln[1:] == s_ln[:-1])
           & (s_seg[1:] == s_seg[:-1]) & live[1:])
    keep = live.clone()
    keep[1:] &= ~dup
    cand = torch.zeros_like(cand)
    cand[order] = keep
    sel = torch.nonzero(cand).squeeze(1)
    return torch.cat([orig[sel, None].to(torch.int32), rs[sel, None],
                      qs[sel, None], ln[sel, None], cat("total")[sel, None],
                      cat("counts")[sel]], dim=1)


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


def _process_hit_range(ref_pad, query_pad, pos_table, cum, starts, qpos,
                       sub, g0: int, g1: int, ref_len: int, query_len: int,
                       xdrop: int, hspthresh: int, seed_size: int, window,
                       *, pad: int):
    """Expand hits [g0, g1), keep those whose reference position lies in
    the RM window (when one is given), extend them, and fetch the
    candidates: an (n, 8) int64 host array of rs, qs, length, total and
    counts[4], in hit order."""
    ref_loc, query_loc, valid = expand_hits(
        cum, starts, qpos, pos_table, g0, g1, seed_size, HBUF=g1 - g0)
    if window is not None:
        valid &= (ref_loc >= window[0]) & (ref_loc <= window[1])
    res = extend_hits_windowed(ref_pad, query_pad, ref_loc, query_loc, valid,
                               sub, xdrop, hspthresh, ref_len, query_len,
                               pad=pad, W=pad)
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
        # rows per extension program (native route) or per expanded hit
        # range (device route): bounds the device memory of the first
        # window's byte windows
        self.HBUF = HBUF
        self.rm_mode = rm_mode
        if device_seeding is None:
            device_seeding = os.environ.get("SEGALIGN_DEVICE_SEEDING") == "1"
        self.device_seeding = device_seeding
        # first-window width of the native route's extension programs
        # (outputs do not depend on it)
        self.window = window
        self.device = torch.device(device)
        self.sub = torch.as_tensor(
            np.asarray(sub_mat, np.int32).reshape(-1)).to(self.device)
        # the host code of both routes (seed table, dedup, entropy counts)
        # runs in the native library: build and load it now, so that a
        # failure raises here; the native route also seeds with it
        get_lib()
        self._seeder = None
        if not device_seeding:
            self._seeder = ChunkSeeder(chunk_size, self.kmer_size,
                                       transition)
        self.ref_len = 0
        self.q_len = 0
        self.drop_ref()

    def _upload(self, codes: np.ndarray, right_pad: int = 0
                ) -> torch.Tensor:
        return torch.from_numpy(pad_sequence(codes, PAD, right_pad)).to(
            self.device)

    def drop_ref(self):
        """Let go of the reference block's state: the padded reference and,
        on the device route, the index and position tables on the device,
        and the host's copies."""
        self.ref_pad = self.index_table = self.pos_table = None
        self._ref_host = self._host_tables = None

    def set_ref(self, ref_codes: np.ndarray, tables=None):
        """tables: an optional precomputed (index_table, pos_table). The
        old block's state goes first, so that the device never holds two
        blocks (the device route's position table is 4 bytes a base)."""
        self.drop_ref()
        self.ref_len = len(ref_codes)
        self._ref_host = np.ascontiguousarray(ref_codes, np.uint8)
        self.ref_pad = self._upload(ref_codes)
        if tables is None:
            tables = build_seed_table(ref_codes, self.step, self.shape_pos,
                                      self.seed_size, self.kmer_size)
        self._host_tables = tuple(np.ascontiguousarray(t, np.int32)
                                  for t in tables)
        if self.device_seeding:
            index_table, pos_table = self._host_tables
            self.index_table = torch.from_numpy(index_table).to(self.device)
            # expand_hits indexes the position table even with no hits
            self.pos_table = torch.from_numpy(
                pos_table if len(pos_table) else np.zeros(1, np.int32)).to(
                    self.device)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        self.q_len = len(fw_codes)
        # chunk_seeds reads chunk_size + seed_size bytes from a chunk start
        right = (self.chunk_size + self.seed_size + 1 if self.device_seeding
                 else 0)
        self.q_fw = self._upload(fw_codes, right)
        self.q_rc = self._upload(rc_codes, right)
        self._q_fw_host = np.ascontiguousarray(fw_codes, np.uint8)
        self._q_rc_host = np.ascontiguousarray(rc_codes, np.uint8)

    def map_chunks(self, work, depth: int = 4, on_result=None
                   ) -> List[ChunkResult]:
        """Process chunks in order; results in work order.

        The native route runs three stages on three threads: a seeding
        thread seeds the next chunk (_seed_chunk) while this thread
        extends the current one (_extend_seeded), and a finisher thread
        fetches each chunk's candidates and runs the host finalize and
        dedup; at most `depth` finished-but-unread chunks wait. The
        seeding runs one chunk ahead, no further: while a chunk is seeded,
        the one before it waits for this thread, and no more.
        SEGALIGN_OVERLAP=0 (read on every call) runs the serial form
        instead: this thread seeds and extends each chunk
        (dispatch_chunk), and finishes it once `depth` newer ones are
        dispatched. The device route runs chunk by chunk, as in the JAX
        package. on_result(index, ChunkResult), when given, fires as each
        chunk finishes, in work order. An error of any stage raises here
        at its chunk's turn, and no stage's work runs on after this
        returns or raises."""
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

        def seed(w):
            return self._seed_chunk(w.chunk_start, w.chunk_end, w.rev,
                                    window=w.window)

        # the seeding thread is the only caller of the seeder (its scratch
        # buffers are the aligner's); leaving the block waits for it
        with ThreadPoolExecutor(1) as ex, ThreadPoolExecutor(1) as seeding:
            nxt = seeding.submit(seed, work[0]) if len(work) else None
            for i in range(len(work)):
                seeded = nxt.result()
                if i + 1 < len(work):
                    nxt = seeding.submit(seed, work[i + 1])
                pend = self._extend_seeded(seeded)
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
        """Host-native seeding and hit expansion, then the extension and
        candidate compaction on the device (native route): _seed_chunk,
        then _extend_seeded."""
        return self._extend_seeded(
            self._seed_chunk(chunk_start, chunk_end, rev, window))

    def _seed_chunk(self, chunk_start: int, chunk_end: int, rev: bool,
                    window: Optional[Tuple[int, int]] = None
                    ) -> SeededChunk:
        """The native route's host half of a chunk-strand: the native
        seeder's hits, kept to the RM window when one is given, with the
        logical batch ends counting the kept hits. It touches no tensor
        and no device, so map_chunks runs it on a thread of its own."""
        tm = _StageTimer()
        t0 = time.time()
        q_host = self._q_rc_host if rev else self._q_fw_host
        index_table, pos_table = self._host_tables
        ref_loc, query_loc, _, hit_bound, num_seeds, num_hits = (
            self._seeder.seed(
                q_host, chunk_start, chunk_end - chunk_start, index_table,
                pos_table, self.shape_pos, self.seed_size, self.max_hits))
        tm.add("seeds", time.time() - t0)
        s = SeededChunk(chunk_start, chunk_end, rev, num_seeds, num_hits,
                        ref_loc, query_loc, np.asarray(hit_bound, np.int64),
                        tm)
        if num_seeds == 0 or num_hits == 0:
            return s
        t0 = time.time()
        if window is not None:
            # keep the hits in the window; the batch ends count kept hits
            keep = (ref_loc >= window[0]) & (ref_loc <= window[1])
            kept_cum = np.cumsum(keep, dtype=np.int64)
            s.seg_ends = np.where(s.seg_ends > 0,
                                  kept_cum[np.maximum(s.seg_ends - 1, 0)],
                                  0)
            s.ref_loc, s.query_loc = ref_loc[keep], query_loc[keep]
        tm.add("mask", time.time() - t0)
        return s

    def _extend_seeded(self, s: SeededChunk) -> PendingChunk:
        """The native route's device half of a chunk-strand: the extension
        programs over its hits and the compaction of their candidates, on
        the calling thread's device."""
        if len(s.ref_loc) == 0:
            return PendingChunk(s.chunk_start, s.chunk_end, s.rev,
                                s.num_seeds, s.num_hits, None, s.seg_ends)
        q_pad = self.q_rc if s.rev else self.q_fw
        fins = self._dispatch_rows(s.ref_loc, s.query_loc, q_pad, s.tm)
        t0 = time.time()
        out = _pack_compact(fins, torch.from_numpy(s.seg_ends).to(
            self.device))
        self._sync()
        s.tm.add("pack", time.time() - t0)
        s.tm.dump(f"dispatch {s.chunk_start}:{s.chunk_end} rev={s.rev} "
                  f"hits={s.num_hits}")
        return PendingChunk(s.chunk_start, s.chunk_end, s.rev, s.num_seeds,
                            s.num_hits, out, s.seg_ends)

    def _sync(self):
        """Under SEGALIGN_SYNC=1, wait for the device's work (CUDA only)."""
        if self.device.type == "cuda" and \
                os.environ.get("SEGALIGN_SYNC", "") == "1":
            torch.cuda.synchronize(self.device)

    def _dispatch_rows(self, ref_loc: np.ndarray, query_loc: np.ndarray,
                       q_pad: torch.Tensor, tm: _StageTimer) -> list:
        """One extension program per span of at most HBUF hits; each
        program's candidate rows (_program_candidates), in hit order."""
        W = self.window
        fins = []
        for g0 in range(0, len(ref_loc), self.HBUF):
            t0 = time.time()
            r = ref_loc[g0:g0 + self.HBUF]
            q = query_loc[g0:g0 + self.HBUF]
            # the first window's gather starts, as extend_fields_program
            # computes them: the tile gather serves a program whose blocks
            # of 128 windows each fit its staged span
            qtile = tile_spans_ok(np.clip(PAD + q.astype(np.int64) - W, 0,
                                          q_pad.numel() - 2 * W), 2 * W,
                                  Q_TILE)
            rtile = tile_spans_ok(np.clip(PAD + r.astype(np.int64) - W, 0,
                                          self.ref_pad.numel() - 2 * W),
                                  2 * W, R_TILE)
            d_r = torch.from_numpy(r).to(self.device)
            d_q = torch.from_numpy(q).to(self.device)
            tm.add("h2d", time.time() - t0)
            t0 = time.time()
            fin = extend_fields_program(
                self.ref_pad, q_pad, d_r, d_q, len(r), self.sub, self.xdrop,
                self.hspthresh, self.ref_len, self.q_len, pad=PAD, W=W,
                W_CONT=CONT_W, with_counts=False, qtile=qtile, rtile=rtile)
            fins.append(_program_candidates(fin, g0))
            del fin   # the per-hit fields go before the next program's
            self._sync()
            tm.add("extend", time.time() - t0)
        return fins

    def finish_chunk(self, p: PendingChunk) -> ChunkResult:
        """Fetch a dispatched chunk's candidates; split them into logical
        batches; finalize entropy and dedup on the host."""
        nb = len(p.seg_ends)
        if p.out is None or p.out.shape[0] == 0:
            return ChunkResult(np.zeros((0, 4), np.int64), p.num_hits,
                               p.num_seeds, nb)
        tm = _StageTimer()
        t0 = time.time()
        allrows = p.out.cpu().numpy().astype(np.int64)
        tm.add("d2h", time.time() - t0)
        t0 = time.time()
        hsps = self._split_and_finalize(allrows, p)
        tm.add("host_dedup", time.time() - t0)
        tm.dump(f"finish {p.chunk_start}:{p.chunk_end} rev={p.rev} "
                f"cand={len(allrows)}")
        return ChunkResult(hsps, p.num_hits, p.num_seeds, nb)

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
        """Device seeding, batch planning, hit expansion and windowed
        extension of one chunk-strand; host finalize and dedup per logical
        batch."""
        empty = np.zeros((0, 4), np.int64)
        tm = _StageTimer()
        t0 = time.time()
        q = self.q_rc if rev else self.q_fw
        _, qpos, _, starts, cum, stats = chunk_seeds(
            q, self.index_table, chunk_start, chunk_end - chunk_start,
            CHUNK=self.chunk_size, seed_size=self.seed_size,
            shape_pos=self.shape_pos, transition=self.transition, pad=PAD)
        num_seeds, num_hits = stats.tolist()
        if num_seeds == 0:
            return ChunkResult(empty, 0, 0)
        check_chunk_hits(num_hits, chunk_start, int32_cum=True)
        tm.add("seeds", time.time() - t0)
        if num_hits == 0:
            return ChunkResult(empty, 0, num_seeds)
        t0 = time.time()
        ends = _batch_ends(cum, num_hits, self.max_hits)
        tm.add("plan", time.time() - t0)
        all_out: List[np.ndarray] = []
        h0 = 0
        for h1 in ends:
            g0s = range(h0, h1, self.HBUF)
            h0 = max(h0, h1)
            if not g0s:
                continue
            parts = []
            for g0 in g0s:
                t0 = time.time()
                parts.append(_process_hit_range(
                    self.ref_pad, q, self.pos_table, cum, starts, qpos,
                    self.sub, g0, min(g0 + self.HBUF, h1), self.ref_len,
                    self.q_len, self.xdrop, self.hspthresh, self.seed_size,
                    window, pad=PAD))
                tm.add("extend", time.time() - t0)
                tm.add("nrange", 1e-3)
            t0 = time.time()
            rows = np.concatenate(parts)
            out = self._finalize_batch(rows[:, 0], rows[:, 1], rows[:, 2],
                                       rows[:, 3], rev, counts=rows[:, 4:8])
            if out is not None:
                all_out.append(out)
            tm.add("host_dedup", time.time() - t0)
        hsps = np.concatenate(all_out) if all_out else empty
        tm.dump(f"chunk {chunk_start}:{chunk_end} rev={rev} "
                f"hits={num_hits}")
        return ChunkResult(hsps, num_hits, num_seeds, len(ends))
