"""The port's measurement scripts: the counterparts of scripts/
exp_gather_variants.py, probe_env.py, probe_extension.py,
measure_scaling.py (with _scaling_worker.py) and
measure_sharded_vs_replicated.py, and five of the port's own (the slices'
walls and kernel time; the walls of the paths beside the benchmark's
cells, a tree against another; K1 on the sequences alone and its build
variants; K4 on the sequences beside the survivor steps it replaced, on a
pass's programs; the pair and both CLIs on several cards):

    python -m segalign_tpu_torch.scripts.exp_gather_variants [inner]
    python -m segalign_tpu_torch.scripts.probe_env [probe ...]
    python -m segalign_tpu_torch.scripts.probe_extension [probe ...]
    python -m segalign_tpu_torch.scripts.slice_walls [runs]
    python -m segalign_tpu_torch.scripts.path_walls [label [PATH,...]]
    python -m segalign_tpu_torch.scripts.k1s_rows [label] [NAME=FLAGS ...]
    python -m segalign_tpu_torch.scripts.k4s_rows [label]
    python -m segalign_tpu_torch.scripts.measure_scaling [--device ...]
    python -m segalign_tpu_torch.scripts.measure_sharded_vs_replicated
    python -m segalign_tpu_torch.scripts.several_cards

Each measures the CUDA device: without one it exits at once with a
message, and no probe runs on the CPU in its place. Only the last three
run on the CPU as well, when `--device cpu` asks for it by name (their
tests' small runs, whose times are the CPU's). No script catches an
exception. Every run prints the card's name and power limit
first, so that each time it prints stands beside them. Importing these
modules touches no device.
"""

from __future__ import annotations

import statistics
import subprocess
import time


def require_cuda(prog: str):
    """The first CUDA device; exit with a message when there is none."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: torch.cuda.is_available() is false; this "
                         f"script measures a CUDA device and runs nowhere "
                         f"else")
    return torch.device("cuda", 0)


def print_card(prog: str) -> str:
    """Print and return `nvidia-smi --query-gpu=name,power.limit`."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"{prog}: {card}; torch {torch.__version__}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return card


def host_bench(label: str, fn, warm: int, iters: int) -> float:
    """Host clock around each call and a synchronize: what the host waits
    for one call. Prints the median, min and max; returns the median in
    seconds."""
    import torch
    for _ in range(warm):
        fn()
        torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts)
    print(f"{label}: med {med * 1e3:.4f} ms  min {min(ts) * 1e3:.4f}  "
          f"max {max(ts) * 1e3:.4f}", flush=True)
    return med


def event_ms(fn, warm: int, iters: int) -> float:
    """Median device time of one call in ms, from CUDA events recorded
    around each of `iters` calls after `warm` warmup calls."""
    import torch
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def first_call_ms(fn) -> float:
    """Host time of one call and a synchronize, in ms (the first launch of
    a kernel after the library is built)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3
