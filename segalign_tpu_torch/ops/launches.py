"""What the main path's kernels did in this process: each wrapper's launch
count (K1-K5) and the cards' peak memory, for the benchmark's passes and
the pipelines' `stats` event."""

from __future__ import annotations

import torch

from .first_scan import first_scan
from .gather import gather_rows, gather_rows_tile
from .window_scan import window_scan
from .window_scan_wide import window_scan_wide

# the wrappers whose launches are reported; a count only grows (callers
# take differences), so nothing here resets it
KERNELS = dict(first_scan=first_scan, gather_rows=gather_rows,
               gather_rows_tile=gather_rows_tile, window_scan=window_scan,
               window_scan_wide=window_scan_wide)


def launch_counts(since=None) -> dict:
    """Each wrapper's count now, less `since`'s."""
    return {k: fn.launches - (since or {}).get(k, 0)
            for k, fn in KERNELS.items()}


def peak_device_bytes() -> list:
    """torch.cuda.max_memory_allocated of every card, by index; empty when
    this process has not used CUDA."""
    if not torch.cuda.is_initialized():
        return []
    return [torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())]
