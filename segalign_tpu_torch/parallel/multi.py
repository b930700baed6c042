"""Chunk work farmed over the aligners of several devices.

Counterpart of segalign_tpu/parallel/multi.py. Every device holds a copy of
the current reference block, its seed table and the query block; the chunks
of an interval are the unit of work, pulled from a shared queue by one host
thread a device. The seed table is built once on the host and handed to
every aligner. ctypes and PyTorch release the GIL during native seeding,
kernel launches and fetches, so the threads overlap.

A worker that raises gives its chunks back to the queue, and the chunks no
worker finished run on a surviving aligner after the join; only when every
aligner has failed is the first error raised.

What the JAX farm carries for XLA has no counterpart: the compile lock and
the serialised first chunk of each worker guard concurrent first compiles.
The kernels here are built once, before the workers start.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..index.seed_table import build_seed_table
from ..pipeline.device import ChunkResult, DeviceAligner, on_device


@dataclass
class ChunkWork:
    chunk_start: int
    chunk_end: int
    rev: bool
    # the repeat masker's window of reference positions (lo, hi)
    window: Optional[Tuple[int, int]] = None


def resolve_devices(device, num_devices: int = -1) -> List[torch.device]:
    """The devices `num_devices` aligners (or shards) run on.

    `cuda` without an index names the machine's CUDA devices: the first
    num_devices of them (an error if there are fewer), or all of them for
    -1. A device that names one place (`cpu`, `cuda:K`) carries all
    num_devices aligners itself, one for -1: several aligners on one device
    is how the mode runs on the CPU and on a machine with one card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        have = torch.cuda.device_count()
        n = have if num_devices <= 0 else num_devices
        if n > have or n == 0:
            raise RuntimeError(
                f"--device cuda --num_devices {num_devices} needs "
                f"{max(n, 1)} CUDA device(s); this machine has {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * max(num_devices, 1)


class MultiDeviceAligner:
    """Farm chunks over N aligners, each with the whole block state."""

    def __init__(self, *, device, num_devices: int = -1, **kw):
        self.devices = resolve_devices(device, num_devices)
        self.aligners = [DeviceAligner(device=d, **kw)
                         for d in self.devices]
        # what the last map_chunks met: the error of every worker that
        # died, those workers' indices, and the chunks each aligner did
        self.errors: List[BaseException] = []
        self.dead: set = set()
        self.chunks_by: List[int] = [0] * len(self.aligners)
        a0 = self.aligners[0]
        self._table_args = (a0.step, a0.shape_pos, a0.seed_size, a0.kmer_size)

    @property
    def num_devices(self) -> int:
        return len(self.aligners)

    def set_ref(self, ref_codes: np.ndarray, tables=None):
        """tables: an optional precomputed (index_table, pos_table). Every
        aligner lets go of the old block before the new table is built."""
        for a in self.aligners:
            a.drop_ref()
        if tables is None:
            tables = build_seed_table(ref_codes, *self._table_args)
        for a in self.aligners:
            a.set_ref(ref_codes, tables=tables)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        for a in self.aligners:
            a.set_query(fw_codes, rc_codes)

    def map_chunks(self, work: List[ChunkWork],
                   depth: int = 4) -> List[ChunkResult]:
        """Process chunks across all aligners; results in work order.

        On the native route each worker keeps up to `depth` chunks
        dispatched and hands their fetch, finalize and dedup to a finisher
        thread of its own (SEGALIGN_OVERLAP=0 finishes them in the worker
        instead); on the device-seeding route a worker runs chunk by
        chunk. A worker that fails requeues what it had in flight, so the
        surviving workers, or a last pass on one of them, complete it.
        A failure that the requeue absorbed shows in self.errors and
        self.dead, and on stderr."""
        self.errors = errors = []
        self.dead = dead = set()
        self.chunks_by = chunks_by = [0] * len(self.aligners)
        if len(self.aligners) == 1:
            chunks_by[0] = len(work)
            return self.aligners[0].map_chunks(work, depth=depth)

        q: "queue.Queue[tuple[int, ChunkWork]]" = queue.Queue()
        for i, w in enumerate(work):
            q.put((i, w))
        results: List[Optional[ChunkResult]] = [None] * len(work)
        overlap = os.environ.get("SEGALIGN_OVERLAP", "") != "0"
        if any(a.device.type == "cuda" for a in self.aligners):
            # launch() reads the bound launchers without a lock: bind them
            # before any worker launches
            from .. import _build
            _build.kernels()

        def worker(ai: int, aligner: DeviceAligner):
            pend: List[tuple] = []  # (i, w, PendingChunk)
            futs: List[tuple] = []  # (i, w, Future) finishes in flight
            pipelined = not aligner.device_seeding
            cur: Optional[tuple] = None  # (i, w) being dispatched right now
            ex = ThreadPoolExecutor(1) if pipelined and overlap else None

            def done(j, r):
                results[j] = r
                chunks_by[ai] += 1

            def drain_one():
                # a failing finish gives its chunk back before the error
                # travels on; the handler below requeues the rest
                jj, wjj, f = futs.pop(0)
                try:
                    done(jj, f.result())
                except BaseException:
                    if results[jj] is None:
                        q.put((jj, wjj))
                    raise

            def finish(j, wj, pd):
                if ex is None:
                    done(j, aligner.finish_chunk(pd))
                    return
                futs.append((j, wj, ex.submit(aligner._finish_on_device,
                                              pd)))
                while len(futs) > depth + 2:
                    drain_one()

            try:
                # the current CUDA device is per thread; the kernels run on
                # this thread's default stream and the finisher fetches on
                # its own thread's default stream: the same stream, so a
                # fetch is ordered after the kernels it reads
                if aligner.device.type == "cuda":
                    torch.cuda.set_device(aligner.device)
                while True:
                    try:
                        cur = q.get_nowait()
                    except queue.Empty:
                        cur = None
                        break
                    i, w = cur
                    if pipelined:
                        pend.append((i, w, aligner.dispatch_chunk(
                            w.chunk_start, w.chunk_end, w.rev,
                            window=w.window)))
                        cur = None
                        if len(pend) > depth:
                            finish(*pend.pop(0))
                    else:
                        done(i, aligner.seed_and_filter(
                            w.chunk_start, w.chunk_end, w.rev,
                            window=w.window))
                        cur = None
                while pend:
                    finish(*pend.pop(0))
                while futs:
                    drain_one()
            except Exception as e:
                errors.append(e)
                dead.add(ai)
                print(f"segalign_tpu_torch: aligner {ai} on "
                      f"{aligner.device} failed: {e!r}", file=sys.stderr)
                # requeue everything this worker had in flight; finishes
                # that completed keep their results
                for j, wj, f in futs:
                    if f.done() and f.exception() is None:
                        done(j, f.result())
                    elif results[j] is None:
                        q.put((j, wj))
                for j, wj, _ in pend:
                    if results[j] is None:
                        q.put((j, wj))
                if cur is not None and results[cur[0]] is None:
                    q.put(cur)
            finally:
                if ex is not None:
                    ex.shutdown(wait=True)

        threads = [threading.Thread(target=worker, args=(ai, a))
                   for ai, a in enumerate(self.aligners)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        missing = [k for k, r in enumerate(results) if r is None]
        if missing:
            # the other workers may have left before a requeue landed:
            # finish the stragglers on a surviving aligner
            alive = [ai for ai in range(len(self.aligners))
                     if ai not in dead]
            if not alive:
                raise errors[0]
            last = self.aligners[alive[0]]
            print(f"segalign_tpu_torch: retrying {len(missing)} chunk(s) "
                  f"after device failure", file=sys.stderr)
            with on_device(last.device):
                for k in missing:
                    w = work[k]
                    results[k] = last.seed_and_filter(
                        w.chunk_start, w.chunk_end, w.rev, window=w.window)
                    chunks_by[alive[0]] += 1
        return results  # type: ignore[return-value]
