"""Chunk work over the aligner of one device.

Counterpart of segalign_tpu/parallel/multi.py. The port drives one device:
a CUDA device on the card, or the CPU in tests. Farming chunks over several
devices, with requeue on failure, is not ported yet (ROADMAP, Queue 1,
"Multi-device").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..pipeline.device import ChunkResult, DeviceAligner


@dataclass
class ChunkWork:
    chunk_start: int
    chunk_end: int
    rev: bool
    # the repeat masker's window of reference positions (lo, hi)
    window: Optional[Tuple[int, int]] = None


class MultiDeviceAligner:
    """The JAX package's multi-device front end, over one device."""

    def __init__(self, *, device, num_devices: int = -1, **kw):
        if num_devices > 1:
            raise NotImplementedError(
                f"num_devices={num_devices}: the port runs on one device; "
                f"multi-device alignment is ROADMAP Queue 1, "
                f"'Multi-device'")
        self.aligner = DeviceAligner(device=device, **kw)

    @property
    def num_devices(self) -> int:
        return 1

    def set_ref(self, ref_codes: np.ndarray):
        self.aligner.set_ref(ref_codes)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        self.aligner.set_query(fw_codes, rc_codes)

    def map_chunks(self, work: List[ChunkWork],
                   depth: int = 4) -> List[ChunkResult]:
        return self.aligner.map_chunks(work, depth=depth)
