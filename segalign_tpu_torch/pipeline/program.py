"""One extension program of the native route as one device program.

Counterpart of the JAX package's one jitted program a span of the hit
stream and its pack (segalign_tpu/pipeline/device.py
DeviceAligner._dispatch_rows and _pack_compact): nothing between a
chunk-strand's plan and the finisher's fetch of its count waits for the
card.

extend_program is one program on an aligner's fixed-shape buffers
(Buffers): hits [g0, g1) of the chunk-strand whose seeds the buffers
hold (program_hits), HBUF rows whatever g1 - g0, the RM window a mask on
them (a row outside it starts done and finalizes to a non-candidate),
K1s, K4s and finalize (ops/extend_fused.py extend_fields), then the
program's candidates less their exact duplicates (first_of_runs)
appended to the chunk-strand's candidate buffer at its device count, in
hit order. g0, g1 and the window are device scalars: the program holds
no host value but its shapes, and on the card ProgramGraph replays one
capture of it for every program of every chunk-strand of one query
strand. On the CPU it runs eagerly: the route there, and the reference
of the graph everywhere.

pack_candidates dedups the candidate buffer across the programs and
compacts it on the device into a block of fixed size and a device count
(on the card a graph of its own too); the finisher fetches the count,
then the rows (DeviceAligner.finish_chunk).
A program's dedup keeps the first row of every run of equal neighbours,
as the pack does, and that composes over the programs' spans of the hit
stream: the pack keeps the rows that one dedup of all the candidates
keeps (the JAX _pack_compact's), while the buffer holds a few thousand
rows where a chunk-strand of tandem repeats has hundreds of thousands of
candidates (the JAX _pack_compact's note on the benchmark's pair). The buffers are sized by candidates, never by hits:
DeviceAligner grows them to twice the most a chunk-strand has needed,
and extends a chunk-strand that passed them again.
"""

from __future__ import annotations

import threading

import torch

from ..ops.extend_fused import extend_fields
from ..ops.hits import expand_hits
from ..ops.launches import count_launch, recording

# a candidate row: orig (the row's index in the chunk-strand's hit
# stream), rs, qs, length, total, counts[4]
FIELDS = 9
# the RM window of a chunk-strand without one: every int32 position
NO_WINDOW = (-(1 << 31), (1 << 31) - 1)
# the batch end that pads Buffers.seg_ends: past every hit index
END = 1 << 31
# the multiplier of append_candidates' hash of (rs, qs), a prime
HASH_MUL = 1000003
# rows past a candidate buffer's last that take the rows it does not
# keep, a row each lane mod DUMP: spread, the writes to them do not queue
# on one address
DUMP = 1024

# captures of every aligner in the process, one at a time: a farm's
# aligners share a card and capture on threads of their own
_CAPTURE_LOCK = threading.Lock()


class Buffers:
    """The fixed-shape buffers that an aligner's programs read and write,
    on its device: the chunk-strand's seed slots (cum, starts, qpos: (S,)
    int32, written by ops/seeding.py chunk_seeds) and logical batch ends
    (seg_ends: (batches,) int64, padded with END), the program's hit range
    and the chunk-strand's RM window (g0, g1, lo, hi: 0-d int32), and its
    candidate buffer (rows: (cand_rows + DUMP, FIELDS) int32, the last
    DUMP rows the dump of the rows that do not fit; n: 0-d int32, the rows
    appended, those that did not fit too)."""

    def __init__(self, num_slots: int, batches: int, cand_rows: int,
                 device):
        i32 = dict(dtype=torch.int32, device=device)
        self.cum, self.starts, self.qpos = (torch.zeros(num_slots, **i32)
                                            for _ in range(3))
        self.seg_ends = torch.full((batches,), END, dtype=torch.int64,
                                   device=device)
        self.g0, self.g1, self.lo, self.hi, self.n = (
            torch.zeros((), **i32) for _ in range(5))
        self.rows = torch.zeros((cand_rows + DUMP, FIELDS), **i32)

    @property
    def cand_rows(self) -> int:
        return self.rows.shape[0] - DUMP


def program_hits(pos_table, cum, starts, qpos, g0, g1, lo, hi, *,
                 HBUF: int, seed_size: int):
    """The HBUF rows of the program at g0: (ref_loc, query_loc, orig,
    valid), valid for hits [g0, g1) whose reference position lies in
    [lo, hi]; orig is each row's index in the chunk-strand's hit stream.
    g0, g1, lo and hi: ints, or 0-d int32 tensors on cum's device."""
    ref_loc, query_loc, valid = expand_hits(cum, starts, qpos, pos_table,
                                            g0, g1, seed_size, HBUF=HBUF)
    valid &= (ref_loc >= lo) & (ref_loc <= hi)
    orig = g0 + torch.arange(HBUF, dtype=torch.int32, device=cum.device)
    return ref_loc, query_loc, orig, valid


def first_of_runs(key, live, rs, qs, ln, seg):
    """The rows to keep of `live` (bool, row order): every live row but
    one whose neighbour before it, in the stable order of `key` with the
    rows not live after them all, is live and equal on rs, qs, the length
    ln and the logical batch seg (all int32 or int64, row order).

    With the int64 key (rs << 31) | qs this is the JAX _pack_compact's
    rule: within an extent's start the order is the rows', so it keeps the
    first row of every run of equal (ln, seg), and on rows that are spans
    of one stream, applied to each span and then to the rows kept, it
    keeps what it keeps applied once to the stream. With any key that is
    a function of (rs, qs), such as a hash of them, a row's live
    neighbour equal on (rs, qs) is still the row before it of its
    extent's start, so this drops only rows that rule drops, and keeps
    every row it keeps."""
    _, order = torch.sort(
        torch.where(live, key, torch.iinfo(key.dtype).max), stable=True)
    s_rs, s_qs, s_ln, s_seg, s_live = (t[order]
                                       for t in (rs, qs, ln, seg, live))
    keep = s_live.clone()
    keep[1:] &= ~(s_live[:-1] & (s_rs[1:] == s_rs[:-1])
                  & (s_qs[1:] == s_qs[:-1]) & (s_ln[1:] == s_ln[:-1])
                  & (s_seg[1:] == s_seg[:-1]))
    kept = torch.empty_like(keep)
    kept[order] = keep
    return kept


def compact_into(out, at0, keep, rows) -> None:
    """Write the rows where `keep`, in order, to out[at0:], and those
    that do not fit before out's last DUMP rows, and every row not kept,
    to those (row i to the (i mod DUMP)-th)."""
    cap = out.shape[0] - DUMP
    at = at0 + torch.cumsum(keep, 0) - 1
    lane = torch.arange(keep.shape[0], device=keep.device) % DUMP
    out.index_copy_(0, torch.where(keep & (at < cap), at, cap + lane), rows)


def append_candidates(buf: Buffers, fin: dict, orig) -> None:
    """Append one program's candidates (finalize's fields; orig, each
    row's index in the hit stream) less duplicates within the program
    (first_of_runs on an int32 hash of (rs, qs), half the radix passes of
    the pack's int64 key: the pack keeps the same rows after it) to
    buf.rows at buf.n, in row order, and advance buf.n."""
    seg = torch.searchsorted(buf.seg_ends, orig, right=True)
    rs, qs, ln = fin["rs"], fin["qs"], fin["length"]
    key = ((rs.long() * HASH_MUL + qs) & 0x7FFFFFFF).int()
    keep = first_of_runs(key, fin["candidate"], rs, qs, ln, seg)
    compact_into(buf.rows, buf.n, keep, torch.cat(
        [orig[:, None], rs[:, None], qs[:, None], ln[:, None],
         fin["total"][:, None], fin["counts"]], dim=1))
    buf.n += keep.sum(dtype=torch.int32)


def extend_program(ref_pad, query_pad, pos_table, sub, buf: Buffers, *,
                   HBUF: int, seed_size: int, xdrop: int, hspthresh: int,
                   ref_len: int, query_len: int, pad: int, W: int,
                   W_CONT: int) -> None:
    """One extension program (module docstring): the hits of buf's
    [g0, g1) in its window extended, and their candidates appended to
    buf.rows at buf.n. No host sync: nothing here reads a device value."""
    ref_loc, query_loc, orig, valid = program_hits(
        pos_table, buf.cum, buf.starts, buf.qpos, buf.g0, buf.g1, buf.lo,
        buf.hi, HBUF=HBUF, seed_size=seed_size)
    fin = extend_fields(ref_pad, query_pad, ref_loc, query_loc, valid, sub,
                        xdrop, hspthresh, ref_len, query_len, pad=pad, W=W,
                        W_CONT=W_CONT, with_counts=False)
    append_candidates(buf, fin, orig)


def pack_candidates(buf: Buffers, kept_rows: int):
    """A chunk-strand's candidates (buf.rows[:buf.n], in ascending hit
    order) less the exact duplicates across its programs, as a
    (kept_rows + DUMP, FIELDS) int32 block whose first `kept` rows are the
    kept ones in hit order, and the device count (2,) int64: kept,
    buf.n. No host sync. When buf.n or kept passes its buffer the block
    is not whole, and the caller extends the chunk-strand again into
    larger buffers.

    A candidate is dropped when another candidate of the same logical hit
    batch has the same extent (rs, qs, length). Identical extents have
    identical totals and counts, so the host's entropy finalize and
    containment dedup give the same HSPs with one copy as with many (see
    segalign_tpu/pipeline/device.py _pack_compact, whose rows and order
    these are: first_of_runs is its rule). rs and qs are int32 positions,
    so the int64 key holds any block; the JAX key, rs plus 2^30 for
    non-candidates, drops every candidate at rs >= 2^30, which the repeat
    masker's block (1 Gbp and its neighbours' overlap, a fifth of the
    genome) passes on any genome over 1.1 Gbp."""
    rows = buf.rows[:buf.cand_rows]
    live = torch.arange(rows.shape[0], device=rows.device) < buf.n
    orig, rs, qs, ln = (rows[:, i] for i in range(4))
    seg = torch.searchsorted(buf.seg_ends, orig.contiguous(), right=True)
    kept = first_of_runs((rs.long() << 31) | qs.long(), live, rs, qs, ln,
                         seg)
    out = torch.empty((kept_rows + DUMP, FIELDS), dtype=torch.int32,
                      device=rows.device)
    compact_into(out, 0, kept, rows)
    return out, torch.stack([kept.sum(), buf.n.long()])


class ProgramGraph:
    """A function of fixed buffers captured once in a CUDA graph on the
    card: `run` (a call of extend_program or pack_candidates) recorded on
    `stream` into the memory pool `pool` (None: a pool of its own), the
    launches its wrappers make recorded with it, and what it returned.
    replay() runs it on the calling thread's current stream, counts those
    launches, as the wrappers count an eager launch, and returns those
    tensors, which the next replay overwrites. A capture that fails
    raises; nothing runs the function eagerly in its place."""

    def __init__(self, run, stream, pool):
        self.graph = torch.cuda.CUDAGraph()
        # thread-local capture mode: another aligner's thread goes on
        # launching on its own stream meanwhile
        with _CAPTURE_LOCK, recording() as self.launches, \
                torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.outputs = run()
            finally:
                # after an error of run's too, which then raises on
                self.graph.capture_end()

    def replay(self):
        self.graph.replay()
        for fn, T in self.launches:
            count_launch(fn, T)
        return self.outputs
