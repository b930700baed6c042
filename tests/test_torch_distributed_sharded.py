"""The port's sharded seed table across processes against the JAX package
on the same inputs: the analog of tests/test_distributed_sharded.py.

Two processes rendezvous through a torch.distributed gloo group on the
loopback and hold two shards each (S = 4). On every case of
tests/test_torch_sharded.py::JAX_SHA256 each rank's results must hash to
the JAX package's digest and equal the in-process run with four shards,
chunk-strand by chunk-strand; so must a set of short chunk-strands in
which rank 1's shards seed nothing (or no shard does, or no seed hits),
which a rank that left early would hang. The cross-process `exchange` and
`gather_to` must equal the in-process ones, uneven and empty groups and
the way back included. One pair of workers runs every case; a worker that
fails or hangs fails the module's tests. tests/test_torch_cuda.py runs the
same workers with their shards on one card."""

import os
import pickle
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from segalign_tpu_torch.parallel import sharded
from segalign_tpu_torch.parallel.multi import ChunkWork
from segalign_tpu_torch.parallel.sharded import ShardedAligner, exchange
from test_torch_multidevice import assert_same, digest
from test_torch_sharded import JAX_SHA256, RC, aligner_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chunk-strands of the pair at chunk 512 (a shard seeds 128 positions):
# rank 1 (positions 256-511 of a chunk) seeds nothing in each; the second
# pair has hits, the third seeds without a hit, the fourth has no seed
SHORT = [(1000, 1100, False), (1000, 1100, True), (40, 80, False),
         (0, 0, False), (3700, 3800, True)]
# exchange: the S x S column counts, uneven, with empty groups and a shard
# that sends nothing; then every count zero
SIZES = [[[0, 3, 0, 5], [2, 0, 0, 1], [0, 0, 0, 0], [4, 1, 6, 2]],
         [[0] * 4] * 4]

_WORKER = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    from segalign_tpu_torch.ops.gather import gather_rows
    from segalign_tpu_torch.ops.window_scan_wide import window_scan_wide
    from segalign_tpu_torch.parallel.distributed import process_group
    from segalign_tpu_torch.parallel.multi import ChunkWork
    from segalign_tpu_torch.parallel.sharded import (ShardedAligner,
                                                     exchange, gather_to)
    path, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    with open(path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    group = process_group()
    out = {"cases": {}, "exchange": [], "gather": None}
    for key, ref, query, work, kw in job["cases"]:
        al = ShardedAligner(device=job["device"], num_devices=2,
                            group=group, **kw)
        assert (al.S, al.first) == (4, 2 * rank)
        al.set_ref(ref)
        al.set_query(query, job["rc"][query[::-1]])
        res = al.map_chunks([ChunkWork(*w) for w in work])
        out["cases"][key] = [(r.hsps, r.num_hits, r.num_seeds) for r in res]
    cpu = [torch.device("cpu")] * 2
    for sizes, send in zip(job["sizes"], job["sends"]):
        mine = send[2 * rank:2 * rank + 2]
        recv = exchange(mine, sizes, cpu, group)
        back = exchange(recv, [list(c) for c in zip(*sizes)], cpu, group)
        out["exchange"].append((recv, back))
    # uneven rows: 3 and 0 on rank 0, 0 and 2 on rank 1
    parts = [torch.arange(3 * 9).reshape(3, 9), torch.zeros((0, 9))] \\
        if rank == 0 else [torch.zeros((0, 9)), -torch.ones((2, 9))]
    out["gather"] = gather_to([p.long() for p in parts], "cpu", group)
    out["launches"] = (gather_rows.launches, window_scan_wide.launches)
    out["host_staged"] = al.host_staged
    with open(f"{path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    print(f"WORKER_OK {rank}")
""")


def _sends(sizes):
    """One (3, n) int32 tensor a shard with distinct values, its columns
    grouped by destination as sizes says."""
    return [torch.arange(100 * s, 100 * s + sum(row), dtype=torch.int32)
            .repeat(3, 1) * torch.tensor([[1], [-1], [7]], dtype=torch.int32)
            for s, row in enumerate(sizes)]


def _cases():
    """(key, ref, query, work, kw) of every JAX case, and the short
    chunk-strands at the first case's settings."""
    out = []
    for key in sorted(JAX_SHA256):
        ref, query, work, kw = aligner_case(*key)
        out.append((key, ref, query, [(w.chunk_start, w.chunk_end, w.rev,
                                       w.window) for w in work], kw))
    ref, query, _, kw = aligner_case(10**9)
    out.append(("short", ref, query, [(*w, None) for w in SHORT], kw))
    return out


def run_two_ranks(d, device):
    """Two gloo workers with their shards on `device` run every case in
    directory d: what each wrote, and the job they ran."""
    job = dict(cases=_cases(), rc=RC, sizes=SIZES, device=device,
               sends=[_sends(s) for s in SIZES])
    path = str(d / "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    script = d / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), path, str(rank), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    except subprocess.TimeoutExpired:
        pytest.fail("the sharded workers hung")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{err[-3000:]}"
        assert f"WORKER_OK {rank}" in out
    got = []
    for rank in range(2):
        with open(f"{path}.{rank}", "rb") as f:
            got.append(pickle.load(f))
    return got, job


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_two_ranks(tmp_path_factory.mktemp("dist_sharded"), "cpu")


class R:
    """A ChunkResult from a worker's (hsps, num_hits, num_seeds)."""

    def __init__(self, t):
        self.hsps, self.num_hits, self.num_seeds = t


def in_process(ref, query, work, kw, device="cpu"):
    """The results of four shards in one process."""
    al = ShardedAligner(device=device, num_devices=4, **kw)
    al.set_ref(ref)
    al.set_query(query, RC[query[::-1]])
    return al.map_chunks([ChunkWork(*w) for w in work])


@pytest.mark.parametrize("key", sorted(JAX_SHA256), ids=str)
def test_two_processes_match_jax_digest(two_ranks, key):
    got, _ = two_ranks
    for rank in range(2):
        assert digest([R(t) for t in got[rank]["cases"][key]]) == \
            JAX_SHA256[key], rank


@pytest.mark.parametrize("key", [*sorted(JAX_SHA256), "short"], ids=str)
def test_two_processes_match_in_process(two_ranks, key):
    """Every rank returns the in-process S = 4 results: HSPs, hits and
    seeds of the whole group."""
    got, job = two_ranks
    _, ref, query, work, kw = next(c for c in job["cases"] if c[0] == key)
    want = in_process(ref, query, work, kw)
    for rank in range(2):
        assert_same([R(t) for t in got[rank]["cases"][key]], want)


def test_a_rank_that_seeds_nothing_joins_in(two_ranks):
    """The short chunk-strands reach rank 1's shards with no position, and
    still cover every exit: hits and HSPs, seeds without hits, no seed."""
    got, job = two_ranks
    loc = -(-512 // 4)
    assert all(ce - cs <= 2 * loc for cs, ce, _ in SHORT)
    res = got[1]["cases"]["short"]
    assert len(res[0][0]) > 0 and res[0][1] > 0
    assert res[2][1] == 0 and res[2][2] > 0
    assert res[3][1:] == (0, 0)


@pytest.mark.parametrize("k", range(len(SIZES)), ids=["uneven", "empty"])
def test_exchange_across_processes_equals_in_process(two_ranks, k):
    got, job = two_ranks
    sizes, send = job["sizes"][k], job["sends"][k]
    cpu = [torch.device("cpu")] * 4
    want = exchange(send, sizes, cpu)
    for rank in range(2):
        recv, back = got[rank]["exchange"][k]
        for m in range(2):
            assert torch.equal(recv[m], want[2 * rank + m])
            assert torch.equal(back[m], send[2 * rank + m])
            assert recv[m].is_contiguous()


def test_gather_to_across_processes(two_ranks):
    got, _ = two_ranks
    want = torch.cat([torch.arange(27).reshape(3, 9),
                      -torch.ones((2, 9))]).long()
    for rank in range(2):
        assert torch.equal(got[rank]["gather"], want)
        # host tensors go through gloo as they are
        assert not got[rank]["host_staged"]


def test_shards_must_be_a_power_of_two(monkeypatch):
    kw = aligner_case(10**9)[3]
    group = object()
    monkeypatch.setattr(sharded, "_rank_world", lambda g: (1, 3))
    with pytest.raises(ValueError, match="power of two"):
        ShardedAligner(device="cpu", num_devices=2, group=group, **kw)
    # one shard a process is enough when the group has two
    monkeypatch.setattr(sharded, "_rank_world", lambda g: (1, 2))
    al = ShardedAligner(device="cpu", num_devices=1, group=group, **kw)
    assert (al.S, al.first, len(al.devices)) == (2, 1, 1)
    assert not al.host_staged
    monkeypatch.setattr(sharded, "_rank_world", lambda g: (0, 1))
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        ShardedAligner(device="cpu", num_devices=1, group=group, **kw)
