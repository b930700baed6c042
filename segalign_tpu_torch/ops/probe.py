"""The launch-cost probe's kernel (S3, S4): out = 2 * x in float32.

Counterpart of the one-block `x * 2` Pallas kernels of scripts/probe_env.py
(probe_pallas) and scripts/probe_extension.py (probe_overhead's ptiny).
CPU tensors take scale2_plain; CUDA tensors launch csrc/probe.cu through
the same ctypes launcher as K1-K5 and count the launch in
`scale2.launches`.
"""

from __future__ import annotations

import torch

from .. import _build
from .launches import count_launch


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def scale2(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 tensor, got "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return scale2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    _build.launch("sa_scale2", x.data_ptr(), x.numel(), out.data_ptr(),
                  _build.stream_of(x.device))
    count_launch(scale2)
    return out


scale2.launches = 0
