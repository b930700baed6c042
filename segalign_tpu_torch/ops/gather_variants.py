"""The gather experiment's kernels: S1 in three modes and S2.

Counterparts of scripts/exp_gather_variants.py _mk (S1: _v1_kernel,
_v2_kernel, _v3_kernel) and _mk4 (S2: _v4_kernel), which split the TPU's
per-row gather (K2) into its pieces: a row's bytes are staged in shared
memory, then the window is cut from them at the row's byte offset. The
kernels stage the 16-byte aligned cover of a window (W + 16 bytes), not the
TPU kernels' 1024-aligned superset of awin_for(W) bytes; the superset only
defines the range of starts a caller may pass:

  gather_dma_only      out[i, k] = seq[(starts[i] // 1024) * 1024 + k]
  gather_extract_only  zeros: rotate-extraction from a bank never loaded
  gather_dbuf          out[i, k] = seq[starts[i] + k], double-buffered
  gather_two_sided     both sides in one launch: r from seq_r at
                       starts2[:B], q from seq_q at starts2[B:]

Starts are NOT clamped, unlike ops/gather.py: the caller keeps every start
in [0, len(seq) - awin_for(W)], as the JAX variants require, and the plain
versions index without clamping (gather_rows_plain's clamp never engages
inside that range). Outputs are (B, W) uint8, as K2's are.

CPU tensors take the plain versions; CUDA tensors launch
csrc/gather_variants.cu and count the launch in the wrapper's `.launches`.
"""

from __future__ import annotations

import torch

from .. import _build
from .gather import gather_rows_plain
from .launches import count_launch

ALIGN = 1024   # the TPU's HBM slice alignment, kept for the superset
AWIN = 2048
MAX_W = 2048   # 129 KB of shared memory a block: 64 rows of W + 16 bytes


def awin_for(W: int) -> int:
    """Bytes of the aligned superset that covers any W-byte window."""
    return max(AWIN, W + ALIGN)


def _check(seqs, starts, W, sides=1):
    for seq in seqs:
        if (seq.dtype != torch.uint8 or seq.dim() != 1
                or not seq.is_contiguous()):
            raise ValueError("seq must be a contiguous 1-D uint8 tensor")
        if seq.is_cuda and seq.data_ptr() % 16:
            raise ValueError("seq must be 16-byte aligned on the card")
        if seq.device != starts.device:
            raise ValueError(f"starts on {starts.device}, seq on "
                             f"{seq.device}")
        if seq.numel() < awin_for(W):
            raise ValueError(f"len(seq)={seq.numel()} is below the "
                             f"superset of {awin_for(W)} bytes")
    if (starts.dtype != torch.int32 or starts.dim() != 1
            or not starts.is_contiguous() or starts.numel() % sides):
        raise ValueError(f"starts must be a contiguous 1-D int32 tensor of "
                         f"a length divisible by {sides}")
    if W <= 0 or W % 16 or W > MAX_W:
        raise ValueError(f"W={W} must be a multiple of 16 in (0, {MAX_W}]")
    if starts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {starts.device}")


def gather_dma_only_plain(seq, starts, W):
    """S1 load only: the first W bytes of each row's aligned superset."""
    return seq.unfold(0, W, 1)[(starts.long() // ALIGN) * ALIGN]


def gather_extract_only_plain(seq, starts, W):
    """S1 extract only: zeros, the value of a bank never loaded."""
    return torch.zeros((starts.numel(), W), dtype=torch.uint8,
                       device=starts.device)


gather_dbuf_plain = gather_rows_plain   # S1 double-buffered: K2's function


def gather_two_sided_plain(seq_r, seq_q, starts2, W):
    """S2: (r, q) = the windows of seq_r at starts2[:B] and of seq_q at
    starts2[B:]."""
    B = starts2.numel() // 2
    return (gather_rows_plain(seq_r, starts2[:B], W),
            gather_rows_plain(seq_q, starts2[B:], W))


def _s1(name, launcher, plain, doc):
    def wrapper(seq: torch.Tensor, starts: torch.Tensor,
                W: int) -> torch.Tensor:
        _check((seq,), starts, W)
        if seq.device.type == "cpu":
            return plain(seq, starts, W)
        out = torch.empty((starts.numel(), W), dtype=torch.uint8,
                          device=seq.device)
        _build.launch(launcher, seq.data_ptr(), starts.data_ptr(),
                      starts.numel(), W, out.data_ptr(),
                      _build.stream_of(seq.device))
        count_launch(wrapper)
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0
    return wrapper


gather_dma_only = _s1(
    "gather_dma_only", "sa_gather_dma_only", gather_dma_only_plain,
    "S1 load only (replaces _v1_kernel): stage the W bytes at each row's "
    "1024-aligned address, write them as they lie.")
gather_extract_only = _s1(
    "gather_extract_only", "sa_gather_extract_only",
    gather_extract_only_plain,
    "S1 extract only (replaces _v2_kernel): cut every row at its offset "
    "from a zeroed bank; reads no sequence byte.")
gather_dbuf = _s1(
    "gather_dbuf", "sa_gather_dbuf", gather_dbuf_plain,
    "S1 double-buffered (replaces _v3_kernel): K2's windows, block t+1's "
    "copies issued before block t is extracted.")


def gather_two_sided(seq_r: torch.Tensor, seq_q: torch.Tensor,
                     starts2: torch.Tensor, W: int):
    """S2 (replaces _v4_kernel): the r and q windows of row i in one
    launch, from starts2 = [r starts | q starts]. Returns (r, q)."""
    _check((seq_r, seq_q), starts2, W, sides=2)
    if seq_r.device.type == "cpu":
        return gather_two_sided_plain(seq_r, seq_q, starts2, W)
    B = starts2.numel() // 2
    r, q = (torch.empty((B, W), dtype=torch.uint8, device=seq_r.device)
            for _ in range(2))
    _build.launch("sa_gather_two_sided", seq_r.data_ptr(), seq_q.data_ptr(),
                  starts2.data_ptr(), B, W, r.data_ptr(), q.data_ptr(),
                  _build.stream_of(seq_r.device))
    count_launch(gather_two_sided)
    return r, q


gather_two_sided.launches = 0
