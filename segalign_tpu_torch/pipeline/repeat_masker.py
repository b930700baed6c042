"""Repeat-masker pipeline: self-alignment coverage intervals.

Counterpart of segalign_tpu/pipeline/repeat_masker.py run_repeat_masker,
which the port cannot share: it imports the JAX package's device pool.
Each block of the genome is aligned against itself, both strands, with the
aligner in rm_mode; each interval's hits are restricted to its window of
the block; the HSPs' query spans are accumulated into coverage, and the
runs covered at least M deep are written as one intervals file per
interval.

load_rm_arena, plan_rm_blocks (with RMInterval and RMBlock) and
coverage_runs_sparse are copies of the functions of that name in
segalign_tpu/pipeline/repeat_masker.py: they are jax-free, but their
module imports jax. tests/test_torch_repeat_masker.py holds each copy
equal to its original. They keep the reference's quirks: coverage counts
are uint8 and wrap at 256, an HSP covers len positions, a covered run that
touches the end of the block is never emitted, and a block with less room
than left_overlap starts at l, not 0. cfg.sharded_table selects the sharded
seed table (parallel/sharded.py) in place of the device farm.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from math import ceil
from typing import List, Optional

import numpy as np

from ..config import RMConfig
from ..constants import E_NT
from ..io.blocks import Chrom
from ..io.encode import encode, revcomp_codes
from ..io.fasta import read_fasta
from ..logging_util import log_event
from ..ops.launches import launch_counts, peak_device_bytes
from .manifest import Manifest

from ..parallel.multi import ChunkWork, MultiDeviceAligner
from ..parallel.sharded import ShardedAligner
from .pairwise import PipelineStats


@dataclass
class RMInterval:
    start: int
    end: int
    ref_start: int
    ref_end: int
    num_invoked: int
    num_intervals: int


@dataclass
class RMBlock:
    index: int
    start: int
    len: int
    intervals: List[RMInterval]


def load_rm_arena(path: str):
    """Whole-genome arena: chromosomes joined by '&'
    (the reference repeat masker, main.cpp:285-309)."""
    pieces = []
    chroms: List[Chrom] = []
    pos = 0
    sep = np.array([E_NT], dtype=np.uint8)
    for i, rec in enumerate(read_fasta(path)):
        codes = encode(rec.seq)
        chroms.append(Chrom(name=rec.name, file_idx=i, start=pos,
                            len=len(codes)))
        pieces.append(codes)
        pieces.append(sep)
        pos += len(codes) + 1
    codes = np.concatenate(pieces)[:-1] if pieces else np.zeros(0, np.uint8)
    return codes, chroms


def plan_rm_blocks(seq_len: int, cfg: RMConfig) -> List[RMBlock]:
    """Block + windowed-interval planning
    (the reference repeat masker, main.cpp:323-432)."""
    interval = cfg.lastz_interval_size
    total_intervals = ceil(seq_len / interval)
    num_neigh = ceil(cfg.neighbor_proportion * total_intervals)
    left_intervals = ceil((num_neigh - 1) / 2) if num_neigh > 0 else 0
    right_intervals = max(num_neigh - 1 - left_intervals, 0)
    left_overlap = left_intervals * interval
    right_overlap = right_intervals * interval
    max_iv_len = left_overlap + interval + right_overlap

    blocks: List[RMBlock] = []
    for l in range(0, seq_len, cfg.seq_block_size):
        block_start = l if l < left_overlap else l - left_overlap
        if l + cfg.seq_block_size + right_overlap > seq_len:
            block_len = seq_len - block_start
        else:
            block_len = (l - block_start) + cfg.seq_block_size + right_overlap

        start_pos = l - block_start
        if block_len < cfg.seq_block_size:
            end_pos = block_len - cfg.seed.size
        else:
            end_pos = start_pos + cfg.seq_block_size - cfg.seed.size

        ivs: List[RMInterval] = []
        p = start_pos
        while p < end_pos:
            iv_start = p
            iv_end = min(end_pos, iv_start + interval)
            left_lim = iv_start < left_overlap
            right_lim = (iv_end + right_overlap) > block_len
            if left_lim:
                ref_start = 0
                if right_lim:
                    ref_end = block_len
                else:
                    ref_end = (block_len if max_iv_len > block_len
                               else max_iv_len)
            else:
                if right_lim:
                    ref_end = block_len
                    ref_start = (0 if block_len < max_iv_len
                                 else block_len - max_iv_len)
                else:
                    ref_start = iv_start - left_overlap
                    ref_end = iv_end + right_overlap
            ivs.append(RMInterval(start=iv_start, end=iv_end,
                                  ref_start=ref_start, ref_end=ref_end,
                                  num_invoked=0, num_intervals=0))
            p += interval
        for k, iv in enumerate(ivs):
            iv.num_invoked = k + 1
            iv.num_intervals = len(ivs)
        blocks.append(RMBlock(index=len(blocks), start=block_start,
                              len=block_len, intervals=ivs))
    return blocks


def coverage_runs_sparse(hsp_starts: np.ndarray, hsp_ends: np.ndarray,
                         block_len: int, M: int):
    """Sparse, exact equivalent of the uint8 coverage accumulation + run
    extraction: O(#HSPs log #HSPs) time and O(#HSPs) memory, instead of a
    block-length (up to 1 GB -> 8 GB int64) dense array per interval.

    Coverage between consecutive event positions is constant, so the
    wrapped (mod 256) comparison against M and the run merging operate on
    the event list directly. Preserves every reference quirk: uint8 wrap
    (256 overlapping HSPs -> coverage 0), and a covered run still open at
    block end is never emitted (the reference repeat masker, seeder.cpp:165-188)."""
    if len(hsp_starts) == 0:
        return []
    pos = np.concatenate([hsp_starts, hsp_ends]).astype(np.int64)
    delta = np.concatenate([
        np.ones(len(hsp_starts), np.int64),
        -np.ones(len(hsp_ends), np.int64)])
    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    delta = delta[order]
    upos, idx = np.unique(pos, return_index=True)
    sums = np.add.reduceat(delta, idx)
    cov = np.cumsum(sums) % 256  # wrapped coverage on [upos[i], upos[i+1])
    covered = cov >= M
    if not covered.any():
        return []
    seg_start = upos
    seg_end = np.concatenate([upos[1:], [block_len]])
    # merge adjacent covered segments
    runs = []
    cur = None
    for s, e, c in zip(seg_start, seg_end, covered):
        s = int(s)
        e = int(min(e, block_len))
        if s >= block_len or e <= s:
            continue
        if c:
            if cur is None:
                cur = [s, e]
            elif s == cur[1]:
                cur[1] = e
            else:
                runs.append(tuple(cur))
                cur = [s, e]
        elif cur is not None:
            runs.append(tuple(cur))
            cur = None
    # a run still open at block end is LOST (reference quirk)
    if cur is not None and cur[1] < block_len:
        runs.append(tuple(cur))
    return runs


def run_repeat_masker(cfg: RMConfig, out_dir: str, *, device,
                      aligner=None, resume: bool = False,
                      device_seeding: Optional[bool] = None
                      ) -> PipelineStats:
    """Run the repeat masker end to end on `device`: one
    tmp{interval}.block{block}.intervals file per interval with runs, in
    out_dir. aligner: a prepared rm_mode aligner (tests); device_seeding
    selects the aligner's device-seeding route (None: the aligner reads
    SEGALIGN_DEVICE_SEEDING)."""
    stats = PipelineStats()
    log = lambda msg: print(msg, file=sys.stderr, flush=True)

    log("\nReading target file ...")
    codes, chroms = load_rm_arena(cfg.seq_filename)
    seq_len = len(codes)
    chr_names = [c.name for c in chroms]
    chr_starts = np.array([c.start for c in chroms], dtype=np.int64)

    blocks = plan_rm_blocks(seq_len, cfg)

    if aligner is None:
        extra = {}
        if cfg.max_hits:
            extra["max_hits"] = cfg.max_hits
        if cfg.sharded_table:
            # the sharded aligner has one route: it seeds on the device
            aligner_cls = ShardedAligner
        else:
            aligner_cls = MultiDeviceAligner
            extra["device_seeding"] = device_seeding
        aligner = aligner_cls(
            device=device, num_devices=cfg.num_devices,
            shape_pos=cfg.seed.shape_pos, seed_size=cfg.seed.size,
            transition=cfg.seed.transition, step=cfg.step,
            sub_mat=cfg.sub_mat, xdrop=cfg.xdrop, hspthresh=cfg.hspthresh,
            noentropy=cfg.noentropy, chunk_size=cfg.wga_chunk_size,
            rm_mode=True, **extra)

    do_plus = cfg.strand in ("plus", "both")
    do_minus = cfg.strand in ("minus", "both")
    manifest = Manifest(out_dir, resume=resume)

    t_start = time.time()
    log("\nStart alignment ...")
    log_event("run_start", mode="repeat_masker", seq=cfg.seq_filename,
              blocks=len(blocks))
    for b in blocks:
        log(f"\nSending block {b.index} ...")
        log_event("rm_block", block=b.index, start=b.start, len=b.len,
                  intervals=len(b.intervals))
        block = codes[b.start:b.start + b.len]
        t0 = time.time()
        aligner.set_ref(block)
        aligner.set_query(block, revcomp_codes(block))
        stats.seed_table_ms += (time.time() - t0) * 1000

        for iv in b.intervals:
            key = (b.index, 0, iv.num_invoked)
            if manifest.is_done(key):
                stats.intervals_done += 1
                continue
            if cfg.debug:
                log(f"Chromosome block {b.index} interval "
                    f"{iv.num_invoked}/{iv.num_intervals} "
                    f"({b.start + iv.start}:{b.start + iv.end})")
            t1 = time.time()
            ev_starts, ev_ends = [], []
            end_pos_rc = b.len - 1 - iv.start
            window = (iv.ref_start, iv.ref_end)
            work = []
            for cs in range(iv.start, iv.end, cfg.wga_chunk_size):
                ce = min(cs + cfg.wga_chunk_size, iv.end)
                if do_plus:
                    work.append(ChunkWork(cs, ce, False, window))
                if do_minus:
                    # the minus strand's chunk of the same span
                    # (the reference repeat masker, seeder.cpp:117-119)
                    mcs = b.len - 1 - ce
                    mce = min(mcs + cfg.wga_chunk_size, end_pos_rc)
                    if mcs < mce:
                        work.append(ChunkWork(mcs, mce, True, window))
            for r in aligner.map_chunks(work):
                stats.num_seeds += r.num_seeds
                stats.num_seed_hits += r.num_hits
                stats.num_hsps += len(r.hsps)
                if len(r.hsps):
                    ev_starts.append(r.hsps[:, 1])
                    ev_ends.append(r.hsps[:, 1] + r.hsps[:, 2])
            stats.extension_ms += (time.time() - t1) * 1000

            none = np.zeros(0, np.int64)
            runs = coverage_runs_sparse(
                np.concatenate(ev_starts) if ev_starts else none,
                np.concatenate(ev_ends) if ev_ends else none, b.len, cfg.M)
            if runs:
                path = os.path.join(
                    out_dir, f"tmp{iv.num_invoked}.block{b.index}.intervals")
                with open(path, "w") as f:
                    for (q0, q1) in runs:
                        seg_q = b.start + int(q0)
                        ci = int(np.searchsorted(chr_starts, seg_q,
                                                 side="right")) - 1
                        c0 = int(chr_starts[ci])
                        ln = int(q1 - q0)
                        f.write(f"{chr_names[ci]}\t{seg_q - c0}\t"
                                f"{seg_q + ln + 1 - c0}\n")
                    if cfg.markend:
                        f.write("# segalign_repeat_masker end-of-file\n")
            manifest.mark_done(key)
            stats.intervals_done += 1
            log_event("interval_done", block=b.index,
                      interval=iv.num_invoked, runs=len(runs),
                      seconds=round(time.time() - t1, 3))

    manifest.close()
    log_event("stats", seeds=stats.num_seeds, seed_hits=stats.num_seed_hits,
              hsps=stats.num_hsps, seconds=round(time.time() - t_start, 3),
              launches=launch_counts(),
              peak_device_bytes=peak_device_bytes())
    log_event("run_end", mode="repeat_masker")
    if cfg.debug:
        log(f"Time elapsed (complete pipeline): "
            f"{time.time() - t_start:.1f} sec")
        log(f"#seeds: {stats.num_seeds}")
        log(f"#seed hits: {stats.num_seed_hits}")
        log(f"#HSPs: {stats.num_hsps}")
    return stats
