"""Window gathers: (B,) starts -> (B, W) uint8 windows of a padded sequence.

gather_rows is the counterpart of segalign_tpu's gather_rows_pallas (K2),
gather_rows_tile of gather_rows_qtile (K3); gather_rows_plain is the plain
version of both. Every start is clamped to [0, len(seq) - W], as
jax.lax.dynamic_slice clamps, so a done row whose offset ran past the
buffer reads a harmless window instead of faulting.

The TPU kernels' 1024-byte aligned supersets, roll extraction and 2^17-row
scalar-memory cap do not exist here. Which rows take the tile gather is a
speed choice only: gather_rows_tile returns the same bytes for any starts,
any T and a sequence at any address (a view that starts off a 16-byte
boundary included): a row that does not lie inside its tile's staged bytes
reads global memory instead.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .launches import count_launch

TILE_ROWS = 128  # rows that share one staged span in gather_rows_tile
MAX_T = 1024     # a span is at most T x 128 bytes, T in (0, MAX_T]


def _check(seq, starts, W):
    if seq.dtype != torch.uint8 or seq.dim() != 1 or not seq.is_contiguous():
        raise ValueError("seq must be a contiguous 1-D uint8 tensor")
    if (starts.dtype != torch.int32 or starts.dim() != 1
            or not starts.is_contiguous()):
        raise ValueError("starts must be a contiguous 1-D int32 tensor")
    if starts.device != seq.device:
        raise ValueError(f"starts on {starts.device}, seq on {seq.device}")
    if W <= 0 or W % 4 or W > seq.numel():
        raise ValueError(f"W={W} must be a positive multiple of 4 and at "
                         f"most len(seq)={seq.numel()}")
    if seq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seq.device}")


def gather_rows_plain(seq: torch.Tensor, starts: torch.Tensor,
                      W: int) -> torch.Tensor:
    """out[i, k] = seq[clamp(starts[i], 0, len(seq) - W) + k]."""
    s = starts.long().clamp(0, seq.numel() - W)
    return seq.unfold(0, W, 1)[s]


def _launch(name, seq, starts, W, *extra):
    out = torch.empty((starts.numel(), W), dtype=torch.uint8,
                      device=seq.device)
    stream = _build.stream_of(seq.device)
    _build.launch(name, seq.data_ptr(), seq.numel(), starts.data_ptr(),
                  starts.numel(), W, *extra, out.data_ptr(), stream)
    return out


def gather_rows(seq: torch.Tensor, starts: torch.Tensor,
                W: int) -> torch.Tensor:
    """K2: one window per start. CPU tensors take the plain version; CUDA
    tensors launch csrc/gather.cu."""
    _check(seq, starts, W)
    if seq.device.type == "cpu":
        return gather_rows_plain(seq, starts, W)
    out = _launch("sa_gather_rows", seq, starts, W)
    count_launch(gather_rows)
    return out


gather_rows.launches = 0


def gather_rows_tile(seq: torch.Tensor, starts: torch.Tensor, W: int,
                     T: int) -> torch.Tensor:
    """K3: the windows of each block of 128 starts cut from one staged span
    of at most T x 128 bytes (the kernel stages no more than 96 KB a tile).
    Same output as gather_rows."""
    _check(seq, starts, W)
    if not 0 < T <= MAX_T:
        raise ValueError(f"T={T} must be in (0, {MAX_T}]")
    if seq.device.type == "cpu":
        return gather_rows_plain(seq, starts, W)
    out = _launch("sa_gather_rows_tile", seq, starts, W, T)
    count_launch(gather_rows_tile, T)
    return out


gather_rows_tile.launches = 0
gather_rows_tile.launches_by_T = {}   # the same count, split by T


def tile_spans_ok(starts: np.ndarray, W: int, T: int) -> bool:
    """Host check that the windows of every block of 128 consecutive starts
    fit a T x 128-byte span, so gather_rows_tile reads each byte of the
    block once (starts need not be sorted: clustering is what counts)."""
    s = np.asarray(starts, np.int64)
    n = len(s)
    if n == 0:
        return False
    full = n - n % TILE_ROWS
    lo = hi = np.zeros(0, np.int64)
    if full:
        blk = s[:full].reshape(-1, TILE_ROWS)
        lo, hi = blk.min(axis=1), blk.max(axis=1)
    if full < n:
        lo = np.append(lo, s[full:].min())
        hi = np.append(hi, s[full:].max())
    return bool(np.all(hi - lo + W <= T * 128))
