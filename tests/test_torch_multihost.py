"""The port's multi-host mode against the JAX package on the same inputs:
hosts split the intervals round-robin and write disjoint files whose union
is what the JAX package writes on one host (and what the port does), and
they rendezvous through torch.distributed when a coordinator is named
(gloo on the loopback)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from segalign_tpu.io.fasta import write_fasta
from segalign_tpu_torch.config import Config
from segalign_tpu_torch.pipeline.pairwise import run_pairwise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def seg_files(d):
    out = {}
    for f in os.listdir(d):
        if f.endswith(".segments"):
            with open(os.path.join(d, f)) as fh:
                out[f] = fh.read()
    return out


def test_two_host_partition_equals_single(tmp_path, monkeypatch):
    """The genomes and settings of tests/test_multihost.py."""
    rng = np.random.default_rng(23)
    core1 = rand_dna(rng, 300)
    core2 = rand_dna(rng, 250)
    t_chr = rand_dna(rng, 300) + core1 + rand_dna(rng, 900) + core2 + \
        rand_dna(rng, 400)
    q_chr = rand_dna(rng, 150) + core1 + rand_dna(rng, 1100) + core2 + \
        rand_dna(rng, 300)
    ref_fa = str(tmp_path / "t.fa")
    query_fa = str(tmp_path / "q.fa")
    write_fasta(ref_fa, [("t", t_chr)])
    write_fasta(query_fa, [("q", q_chr)])

    kw = dict(reference_filename=ref_fa, query_filename=query_fa,
              data_folder="", gapped=False, noentropy=True, hspthresh=1500,
              wga_chunk_size=512, lastz_interval_size=700,
              seq_block_size=10**6, device_hbuf=1024)

    def cfg():
        return Config(**kw)

    # the JAX package's single host, then the port's
    from segalign_tpu.config import Config as JaxConfig
    from segalign_tpu.pipeline.pairwise import run_pairwise as jax_run
    for k in ("SEGALIGN_NUM_HOSTS", "SEGALIGN_HOST_ID", "SEGALIGN_COORD"):
        monkeypatch.delenv(k, raising=False)
    jax_dir, single = str(tmp_path / "jax"), str(tmp_path / "single")
    os.makedirs(jax_dir)
    os.makedirs(single)
    jax_run(JaxConfig(device_batch=256, num_devices=1, **kw), jax_dir)
    want = seg_files(jax_dir)
    assert len(want) > 1
    run_pairwise(cfg(), single, device="cpu")
    assert seg_files(single) == want

    got = {}
    for host in (0, 1):
        d = str(tmp_path / f"host{host}")
        os.makedirs(d)
        monkeypatch.setenv("SEGALIGN_NUM_HOSTS", "2")
        monkeypatch.setenv("SEGALIGN_HOST_ID", str(host))
        run_pairwise(cfg(), d, device="cpu")
        files = seg_files(d)
        assert not (set(files) & set(got)), "hosts overlapped on intervals"
        got.update(files)
    assert got == want


def test_multihost_cli_flags(tmp_path, monkeypatch):
    """--num_hosts/--host_id through the port's CLI, a process a host (the
    genomes and flags of tests/test_distributed_init.py): the hosts' lines
    are disjoint and their union is the single host's, which is the JAX
    CLI's."""
    rng = np.random.default_rng(5)
    core = rand_dna(rng, 400)
    t_chr = rand_dna(rng, 300) + core + rand_dna(rng, 800) + core
    q_chr = rand_dna(rng, 150) + core + rand_dna(rng, 1000)
    ref_fa, query_fa = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    write_fasta(ref_fa, [("t", t_chr)])
    write_fasta(query_fa, [("q", q_chr)])
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("SEGALIGN_NUM_HOSTS", "SEGALIGN_HOST_ID", "SEGALIGN_COORD"):
        env.pop(k, None)

    argv = [ref_fa, query_fa, "--nogapped", "--hspthresh", "1500",
            "--noentropy", "--wga_chunk_size", "512",
            "--lastz_interval_size", "600"]

    def start(outfile, extra):
        return subprocess.Popen(
            [sys.executable, "-m", "segalign_tpu_torch.cli.run_segalign",
             *argv, "--device", "cpu", "--output", outfile, *extra],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    outs = [str(tmp_path / f"{n}.segments") for n in ("single", "h0", "h1")]
    procs = [start(outs[0], []),
             start(outs[1], ["--num_hosts", "2", "--host_id", "0"]),
             start(outs[2], ["--num_hosts", "2", "--host_id", "1"])]
    lines = []
    for p, out in zip(procs, outs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a CLI process timed out")
        assert p.returncode == 0, err[-2000:]
        got = set()
        if os.path.exists(out):   # a slice may have no alignments
            with open(out) as f:
                got = set(ln for ln in f.read().splitlines() if ln)
        lines.append(got)
    single, h0, h1 = lines
    from segalign_tpu.cli.run_segalign import main as jax_main
    for k in ("SEGALIGN_NUM_HOSTS", "SEGALIGN_HOST_ID", "SEGALIGN_COORD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    jax_out = str(tmp_path / "jax.segments")
    assert jax_main([*argv, "--num_devices", "1", "--output", jax_out]) == 0
    with open(jax_out) as f:
        assert single == set(ln for ln in f.read().splitlines() if ln)
    assert single
    assert h0 & h1 == set(), "hosts overlapped on intervals"
    assert h0 | h1 == single
    assert "Host 1/2:" in err   # the last process was host 1


_WORKER = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from segalign_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, partition_intervals, process_group)
    assert process_group() is None
    host_id, num_hosts = maybe_initialize_distributed("cpu")
    assert num_hosts == 2
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert dist.get_world_size() == 2 and dist.get_rank() == host_id
    group = process_group()
    assert group is not None and dist.get_world_size(group) == 2
    x = torch.full((4,), host_id + 1, dtype=torch.int32)
    dist.all_reduce(x, group=group)
    assert x.tolist() == [3] * 4, x
    # a second call joins nothing anew
    assert maybe_initialize_distributed("cpu") == (host_id, 2)
    ivs = list(range(11))
    assert partition_intervals(ivs, host_id, num_hosts) == ivs[host_id::2]
    dist.destroy_process_group()
    print(f"WORKER_OK {host_id}")
""")


def test_two_process_distributed(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = []
    for hid in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, SEGALIGN_NUM_HOSTS="2",
                   SEGALIGN_HOST_ID=str(hid),
                   SEGALIGN_COORD=f"127.0.0.1:{port}",
                   GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append((p.returncode, out, err))
    for hid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {hid} failed:\n{err[-2000:]}"
        assert f"WORKER_OK {hid}" in out


def test_single_host_joins_no_group(monkeypatch):
    import torch.distributed as dist
    from segalign_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, process_group)
    for k in ("SEGALIGN_NUM_HOSTS", "SEGALIGN_HOST_ID", "SEGALIGN_COORD"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_initialize_distributed("cpu") == (0, 1)
    # several hosts without a coordinator: the replicated mode, no group
    monkeypatch.setenv("SEGALIGN_NUM_HOSTS", "3")
    monkeypatch.setenv("SEGALIGN_HOST_ID", "2")
    assert maybe_initialize_distributed("cuda") == (2, 3)
    # a coordinator with one host is ignored
    monkeypatch.setenv("SEGALIGN_NUM_HOSTS", "1")
    monkeypatch.setenv("SEGALIGN_COORD", "127.0.0.1:1")
    assert maybe_initialize_distributed("cpu") == (2, 1)
    assert not dist.is_initialized()
    assert process_group() is None
    # the device is named by every caller
    with pytest.raises(TypeError):
        maybe_initialize_distributed()
