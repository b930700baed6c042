"""Host padding of a sequence block (numpy).

Counterpart of segalign_tpu/ops/extend_tiled.py pad_sequence_2d, which the
port cannot import (that module imports jax). The padded sequence is what
every window gather reads: `pad` bytes of fill before the codes and at
least `pad` after them, so that no window of an alive extension row, at
most `pad` bytes wide, leaves the buffer. A query that the device seeds
(ops/seeding.py) needs more after them: a right pad of at least the chunk
size plus the seed size. The fill is code 6, which scores as a wall
against every base.
"""

from __future__ import annotations

import numpy as np

PAD_CODE = 6


def pad_sequence(codes: np.ndarray, pad: int, right_pad: int = 0
                 ) -> np.ndarray:
    """1-D uint8 padded sequence with `pad` bytes before the codes and at
    least max(pad, right_pad) after them, rounded up to a multiple of 1024
    bytes: without right_pad, the bytes of segalign_tpu's
    pad_sequence_2d(codes, pad, 0, 0)."""
    n = len(codes)
    total = pad + n + max(pad, right_pad)
    out = np.full(-(-total // 1024) * 1024, PAD_CODE, np.uint8)
    out[pad:pad + n] = codes
    return out
