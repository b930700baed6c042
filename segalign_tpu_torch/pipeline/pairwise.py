"""Pairwise whole-genome alignment, ungapped stage (host orchestration).

Counterpart of segalign_tpu/pipeline/pairwise.py run_pairwise. Reference
blocks are the outer loop and query blocks the inner one, so each
reference block's seed table is built once; the chunks of each interval
stream through the aligner: the farm over one or several devices
(parallel/multi.py), or the sharded seed table (parallel/sharded.py) for
cfg.sharded_table. Of several hosts each aligns its round-robin slice of
the intervals and writes its own files (parallel/distributed.py).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..config import Config
from ..io.blocks import build_arena, chunk_interval, plan_intervals
from ..io.fasta import read_fasta
from ..logging_util import log_event
from ..ops.launches import launch_counts, peak_device_bytes
from ..output.segments import PrinterContext, write_interval_segments
from .manifest import Manifest

from ..parallel.distributed import (maybe_initialize_distributed,
                                    partition_intervals)
from ..parallel.multi import ChunkWork, MultiDeviceAligner
from ..parallel.sharded import ShardedAligner


@dataclass
class PipelineStats:
    num_seeds: int = 0
    num_seed_hits: int = 0
    num_hsps: int = 0
    seed_table_ms: float = 0.0
    extension_ms: float = 0.0
    intervals_done: int = 0
    # the branches a run took: target blocks, and of its chunk-strands the
    # logical hit batches (the reference's max_hits batching) in all, the
    # chunk-strands whose hits max_hits cut (three batches or more: the
    # plan gives the last seed's hits a batch of their own whenever a
    # chunk-strand has hits) and the fewest and most hits of one (None
    # before the first)
    ref_blocks: int = 0
    chunk_strands: int = 0
    hit_batches: int = 0
    split_chunks: int = 0
    min_chunk_hits: Optional[int] = None
    max_chunk_hits: Optional[int] = None
    # the native route's chunk-strands extended again, their candidates
    # past the buffers (a chunk-strand extended twice counts twice)
    reextended: int = 0

    def add_chunk(self, r) -> None:
        """Count one chunk-strand's ChunkResult."""
        self.num_seeds += r.num_seeds
        self.num_seed_hits += r.num_hits
        self.num_hsps += len(r.hsps)
        self.chunk_strands += 1
        self.hit_batches += r.num_batches
        self.split_chunks += r.num_batches >= 3
        self.min_chunk_hits = (r.num_hits if self.min_chunk_hits is None
                               else min(self.min_chunk_hits, r.num_hits))
        self.max_chunk_hits = max(self.max_chunk_hits or 0, r.num_hits)
        self.reextended += r.reextended

    def log(self, seconds: float) -> None:
        """The `stats` event: the counts, the ungapped stage's seconds, the
        kernels' launches in the process and each card's peak memory."""
        log_event("stats", seeds=self.num_seeds,
                  seed_hits=self.num_seed_hits, hsps=self.num_hsps,
                  seconds=round(seconds, 3), ref_blocks=self.ref_blocks,
                  chunk_strands=self.chunk_strands,
                  hit_batches=self.hit_batches,
                  split_chunks=self.split_chunks,
                  min_chunk_hits=self.min_chunk_hits,
                  max_chunk_hits=self.max_chunk_hits,
                  reextended=self.reextended,
                  launches=launch_counts(),
                  peak_device_bytes=peak_device_bytes())


def run_pairwise(cfg: Config, out_dir: str, *, device,
                 emit: Optional[Callable[[str], None]] = None,
                 resume: bool = False,
                 device_seeding: Optional[bool] = None
                 ) -> PipelineStats:
    """Run the ungapped stage end to end on `device`.

    Writes query_block*.name / ref_block*.name and tmp*.segments files into
    out_dir, and passes each lastz command line to `emit` (default: print
    to stdout, the reference's data channel). device_seeding selects the
    aligner's device-seeding route (None: the aligner reads
    SEGALIGN_DEVICE_SEEDING)."""
    if emit is None:
        emit = lambda line: print(line, flush=True)
    stats = PipelineStats()
    log = lambda msg: print(msg, file=sys.stderr, flush=True)

    log("\nReading query file ...")
    query = build_arena(read_fasta(cfg.query_filename), cfg.seq_block_size,
                        with_rc=True)
    log("\nReading target file ...")
    target = build_arena(read_fasta(cfg.reference_filename),
                         cfg.seq_block_size, with_rc=False)

    # block name files (consumed by lastz's [subset=...] in the gapped stage)
    for b in query.blocks:
        with open(os.path.join(out_dir, f"query_block{b.index}.name"),
                  "w") as f:
            for ci in b.chroms:
                f.write(query.chroms[ci].name + "\n")
    for b in target.blocks:
        with open(os.path.join(out_dir, f"ref_block{b.index}.name"),
                  "w") as f:
            for ci in b.chroms:
                f.write(target.chroms[ci].name + "\n")

    intervals = plan_intervals(query.blocks, cfg.seed.size,
                               cfg.lastz_interval_size)
    host_id, num_hosts = maybe_initialize_distributed(device)
    my_intervals = partition_intervals(intervals, host_id, num_hosts)
    if num_hosts > 1:
        log(f"Host {host_id}/{num_hosts}: {len(my_intervals)} of "
            f"{len(intervals)} intervals")
    ctx = PrinterContext(
        r_chr_names=[c.name for c in target.chroms],
        r_chr_starts=target.chr_starts,
        q_chr_names=[c.name for c in query.chroms],
        q_chr_starts=query.chr_starts,
        rc_q_chr_names=[c.name for c in query.rc_chroms],
        rc_q_chr_starts=query.rc_chr_starts,
        rc_q_chr_lens=np.array([c.len for c in query.rc_chroms], np.int64),
        out_dir=out_dir)

    extra = {}
    if cfg.max_hits:
        extra["max_hits"] = cfg.max_hits
    if cfg.device_hbuf:
        extra["HBUF"] = cfg.device_hbuf
    if cfg.sharded_table:
        # the sharded aligner has one route: it seeds on the device
        aligner_cls = ShardedAligner
    else:
        aligner_cls = MultiDeviceAligner
        extra["device_seeding"] = device_seeding
    aligner = aligner_cls(
        device=device, num_devices=cfg.num_devices,
        shape_pos=cfg.seed.shape_pos, seed_size=cfg.seed.size,
        transition=cfg.seed.transition, step=cfg.step, sub_mat=cfg.sub_mat,
        xdrop=cfg.xdrop, hspthresh=cfg.hspthresh, noentropy=cfg.noentropy,
        chunk_size=cfg.wga_chunk_size, **extra)
    log(f"Using {aligner.num_devices} device(s): {device}"
        + (" [sharded table]" if cfg.sharded_table else ""))

    do_plus = cfg.strand in ("plus", "both")
    do_minus = cfg.strand in ("minus", "both")
    manifest = Manifest(out_dir, resume=resume)

    stats.ref_blocks = len(target.blocks)
    t_start = time.time()
    log("\nStart alignment ...")
    log_event("run_start", mode="pairwise", ref=cfg.reference_filename,
              query=cfg.query_filename, intervals=len(my_intervals),
              host=host_id, num_hosts=num_hosts)
    for rb in target.blocks:
        log(f"\nSending reference block {rb.index} ...")
        log_event("ref_block", block=rb.index, start=rb.start, len=rb.len)
        t0 = time.time()
        aligner.set_ref(target.codes[rb.start:rb.start + rb.len])
        stats.seed_table_ms += (time.time() - t0) * 1000

        for qb in query.blocks:
            log(f"\nSending query block {qb.index} ...")
            log_event("query_block", block=qb.index, len=qb.len)
            aligner.set_query(query.codes[qb.start:qb.start + qb.len],
                              query.rc_codes[qb.start:qb.start + qb.len])
            q_len = qb.len - cfg.seed.size

            for iv in (i for i in my_intervals if i.block == qb.index):
                key = (rb.index, qb.index, iv.num_invoked)
                if manifest.is_done(key):
                    stats.intervals_done += 1
                    continue
                if cfg.debug:
                    log(f"Query block {qb.index}, interval "
                        f"{iv.num_invoked}/{iv.num_intervals} "
                        f"({iv.start}:{iv.end})")
                t1 = time.time()
                fw_work, rc_work = [], []
                if do_plus:
                    fw_work = [ChunkWork(cs, ce, False) for (cs, ce) in
                               chunk_interval(iv.start, iv.end,
                                              cfg.wga_chunk_size)]
                if do_minus:
                    rc_work = [ChunkWork(cs, ce, True) for (cs, ce) in
                               chunk_interval(q_len - iv.end,
                                              q_len - iv.start,
                                              cfg.wga_chunk_size)]
                results = aligner.map_chunks(fw_work + rc_work)
                fw_parts, rc_parts = [], []
                for k, r in enumerate(results):
                    stats.add_chunk(r)
                    if len(r.hsps):
                        (fw_parts if k < len(fw_work)
                         else rc_parts).append(r.hsps)
                stats.extension_ms += (time.time() - t1) * 1000

                fw_hsps = (np.concatenate(fw_parts) if fw_parts
                           else np.zeros((0, 4), np.int64))
                rc_hsps = (np.concatenate(rc_parts) if rc_parts
                           else np.zeros((0, 4), np.int64))
                for cmd in write_interval_segments(
                        ctx, cfg, num_invoked=iv.num_invoked,
                        q_block_index=qb.index, r_block_index=rb.index,
                        r_block_start=rb.start, q_block_start=qb.start,
                        fw_hsps=fw_hsps, rc_hsps=rc_hsps):
                    emit(cmd)
                manifest.mark_done(key)
                stats.intervals_done += 1
                log_event("interval_done", ref_block=rb.index,
                          query_block=qb.index, interval=iv.num_invoked,
                          hsps=len(fw_hsps) + len(rc_hsps),
                          seconds=round(time.time() - t1, 3))

    manifest.close()
    stats.log(time.time() - t_start)
    log_event("run_end", mode="pairwise")
    if cfg.debug:
        log(f"Time elapsed (complete pipeline): "
            f"{time.time() - t_start:.1f} sec")
        log(f"#seeds: {stats.num_seeds}")
        log(f"#seed hits: {stats.num_seed_hits}")
        log(f"#HSPs: {stats.num_hsps}")
    return stats
