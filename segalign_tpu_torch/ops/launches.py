"""What the main path's kernels did in this process: each wrapper's launch
count (K1 on gathered rows and on the sequences, K2-K5, K4s) and the cards'
peak memory, for the benchmark's passes and the pipelines' `stats` event.

Every wrapper (K1-K5, S1-S4) counts a launch with count_launch, under one
lock: the farm's worker threads and their finishers launch at once, and a
bare `fn.launches += 1` loses increments between threads. The count lives
on the wrapper (`fn.launches`, and K3's `launches_by_T`), where callers
read it and set it to 0."""

from __future__ import annotations

import threading

import torch

_LOCK = threading.Lock()


def count_launch(fn, T=None):
    """Add one to `fn.launches` (and to `fn.launches_by_T[T]` when T is
    given); the wrappers call it where they launch their kernel."""
    with _LOCK:
        fn.launches += 1
        if T is not None:
            fn.launches_by_T[T] = fn.launches_by_T.get(T, 0) + 1


def launch_counts(since=None) -> dict:
    """Each main-path wrapper's count now, less `since`'s (a count only
    grows: callers take differences, so nothing here resets it)."""
    # imported here: the wrappers import count_launch from this module
    from .first_scan import first_scan, first_scan_seq
    from .gather import gather_rows, gather_rows_tile
    from .window_scan import window_scan, window_scan_seq
    from .window_scan_wide import window_scan_wide
    kernels = dict(first_scan=first_scan, first_scan_seq=first_scan_seq,
                   gather_rows=gather_rows,
                   gather_rows_tile=gather_rows_tile,
                   window_scan=window_scan, window_scan_seq=window_scan_seq,
                   window_scan_wide=window_scan_wide)
    return {k: fn.launches - (since or {}).get(k, 0)
            for k, fn in kernels.items()}


def peak_device_bytes() -> list:
    """torch.cuda.max_memory_allocated of every card, by index; empty when
    this process has not used CUDA."""
    if not torch.cuda.is_initialized():
        return []
    return [torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())]
