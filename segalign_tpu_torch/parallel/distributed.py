"""Multi-host distribution.

Counterpart of segalign_tpu/parallel/distributed.py. Every host holds the
whole reference block and its seed table, as every device of one host does,
and aligns a disjoint round-robin slice of the query intervals. Each host
writes its own files, which merge afterwards by the same sort -V contract
as one host's. Nothing passes between the hosts during alignment.

Launch: run the same command on every host with
  SEGALIGN_NUM_HOSTS=N SEGALIGN_HOST_ID=i [SEGALIGN_COORD=ip:port]
or the CLI's --num_hosts / --host_id / --coordinator. A coordinator is
needed only by code that communicates between the hosts; when one is
given, the hosts join one torch.distributed process group, which
process_group() returns. The CLIs' split uses none. A caller that spreads
the sharded seed table over the hosts passes it on explicitly:

    maybe_initialize_distributed(device)
    ShardedAligner(device=..., group=process_group(), ...)

and then every host calls the aligner with the same blocks and chunks
(parallel/sharded.py), not its own slice of the intervals.
"""

from __future__ import annotations

import os
from typing import List


def maybe_initialize_distributed(device) -> tuple[int, int]:
    """(host_id, num_hosts) from the SEGALIGN_* environment; (0, 1) for a
    single host.

    With several hosts and a coordinator address, joins the
    torch.distributed process group at tcp://<coordinator>, once a
    process: gloo for a CPU `device`, NCCL for a CUDA one."""
    num_hosts = int(os.environ.get("SEGALIGN_NUM_HOSTS", "1"))
    host_id = int(os.environ.get("SEGALIGN_HOST_ID", "0"))
    coord = os.environ.get("SEGALIGN_COORD", "")
    if num_hosts > 1 and coord:
        import torch
        import torch.distributed as dist
        if not dist.is_initialized():
            backend = ("nccl" if torch.device(device).type == "cuda"
                       else "gloo")
            dist.init_process_group(
                backend, init_method=f"tcp://{coord}", rank=host_id,
                world_size=num_hosts)
    return host_id, num_hosts


def process_group():
    """The torch.distributed group that maybe_initialize_distributed joined;
    None when this process is alone."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def partition_intervals(intervals: List, host_id: int, num_hosts: int):
    """Deterministic round-robin slice of the interval work list.

    Round-robin (not contiguous blocks) spreads dense regions across hosts,
    the law-of-large-numbers balancing the reference gets from its dynamic
    GPU checkout (src/seed_filter.cu:700-706)."""
    if num_hosts <= 1:
        return intervals
    return [iv for i, iv in enumerate(intervals) if i % num_hosts == host_id]
