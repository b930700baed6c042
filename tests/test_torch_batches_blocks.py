"""The port past one logical hit batch and one target block, on the CPU.

Both CLIs over several target and query blocks, with a --max_hits that
cuts most chunk-strands' hits into several logical batches (the
reference's max_hits batching, on which the dedup depends), on every
route, against the JAX CLIs byte for byte; the programs' candidate
buffer and pack against the JAX package's _pack_compact; an aligner letting go
of its old block before it takes the next; and the launch count under
threads."""

import gc
import os
import threading
import weakref

import numpy as np
import pytest
import torch

from segalign_tpu_torch.io.blocks import build_arena
from segalign_tpu_torch.io.fasta import read_fasta
from segalign_tpu_torch.pipeline.pairwise import PipelineStats

# max_hits values that cut most chunk-strands' hits into several batches
# (on the CPU the device route pays for each batch, the native route for
# each chunk-strand: the sizes keep both few)
PAIR = ["--nogapped", "--markend", "--seq_block_size", "8000",
        "--lastz_interval_size", "6000", "--wga_chunk_size", "10000",
        "--max_hits", "64"]
RM = ["--markend", "--seq_block_size", "3000", "--lastz_interval_size",
      "1000", "--wga_chunk_size", "1000", "--max_hits", "400"]
ROUTES = {
    "native": ([], {}),
    "device_seeding": ([], {"SEGALIGN_DEVICE_SEEDING": "1"}),
    "farm2": (["--num_devices", "2"], {}),
    "sharded2": (["--sharded_table", "--num_devices", "2"], {}),
}


def _genome(rng, n, elems, spacing=1000):
    """Random bases with a copy of one of `elems` (either strand, 12% of
    its bases changed) about every `spacing` bases: hits on every chunk."""
    g = rng.integers(0, 4, n)
    for p in range(100, n - 500, spacing):
        p += int(rng.integers(0, 100))
        e = elems[int(rng.integers(0, len(elems)))]
        if rng.random() < 0.5:
            e = 3 - e[::-1]
        mut = rng.random(len(e)) < 0.12
        g[p:p + len(e)] = np.where(
            mut, (e + rng.integers(1, 4, len(e))) % 4, e)
    return g


def _write_records(path, codes, names):
    n = len(codes) // len(names)
    with open(path, "w") as f:
        for i, name in enumerate(names):
            s = np.frombuffer(b"ACGT", np.uint8)[
                codes[i * n:(i + 1) * n]].tobytes().decode()
            f.write(f">{name}\n" + "".join(
                s[j:j + 60] + "\n" for j in range(0, len(s), 60)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 20 kb target in three records and a 20 kb query in two (at
    --seq_block_size 8000 two target blocks and two query blocks), and the
    repeat masker's 6 kb genome in two records (three blocks of 3000 with
    their neighbours' overlap), all carrying copies of six repeat
    elements."""
    rng = np.random.default_rng(5)
    elems = [rng.integers(0, 4, int(n)) for n in rng.integers(200, 400, 6)]
    d = tmp_path_factory.mktemp("batches_blocks")
    paths = [str(d / f) for f in ("ref.fa", "query.fa", "rm.fa")]
    for path, n, names in zip(paths, (20_000, 20_000, 6_000),
                              (["c1", "c2", "c3"], ["d1", "d2"],
                               ["e1", "e2"])):
        _write_records(path, _genome(rng, n, elems), names)
    return paths


@pytest.fixture(scope="module")
def pair(files):
    return files[:2]


def _run(main, argv, out):
    assert main([*argv, "--output", out]) == 0
    with open(out, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_pairwise(pair, tmp_path_factory):
    from segalign_tpu.cli.run_segalign import main
    return _run(main, [*pair, *PAIR],
                str(tmp_path_factory.mktemp("jax_pw") / "out"))


@pytest.fixture(scope="module")
def jax_rm(files, tmp_path_factory):
    from segalign_tpu.cli.run_segalign_repeat_masker import main
    return _run(main, [files[2], *RM],
                str(tmp_path_factory.mktemp("jax_rm") / "out"))


def _port(module, argv, route, tmp_path, monkeypatch):
    """The port CLI's bytes on `route` with --device cpu, and the stats
    its pipeline logged."""
    import importlib
    main = importlib.import_module(
        f"segalign_tpu_torch.cli.{module}").main
    extra, env = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(PipelineStats, "log",
                        lambda self, seconds: seen.append(self))
    monkeypatch.chdir(tmp_path)
    data = _run(main, [*argv, *extra, "--device", "cpu"],
                str(tmp_path / "out"))
    assert len(seen) == 1
    return data, seen[0]


def test_pair_has_several_blocks(pair):
    for path in pair:
        assert len(build_arena(read_fasta(path), 8000, False).blocks) == 2


def test_block_1000_layout_is_two_blocks():
    """block-1000's layout (50 records of equal length) at a block size of
    25 records: the 25th record closes the first block (its separators
    take it past the size), so two full blocks."""
    from segalign_tpu_torch import bench_inputs
    ref_mbp, _, (prefix, count), _ = bench_inputs.SCALE_INPUTS["block-1000"]
    n = 1000 * count
    names, lengths = bench_inputs.record_layout(prefix, count, n)
    assert set(lengths) == {n // count}
    codes = np.random.default_rng(0).integers(0, 4, n).astype(np.uint8)
    arena = build_arena(
        [type("R", (), {"name": a, "seq": np.frombuffer(b"ACGT", np.uint8)[
            codes[i * 1000:(i + 1) * 1000]].tobytes()})
         for i, a in enumerate(names)], 25 * 1000, False)
    assert [len(b.chroms) for b in arena.blocks] == [25, 25]
    assert ref_mbp * 1e6 / count * 25 == 500_000_000


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pairwise_cli_batches_and_blocks_identical_to_jax(
        route, pair, jax_pairwise, tmp_path, monkeypatch):
    data, st = _port("run_segalign", [*pair, *PAIR], route, tmp_path,
                     monkeypatch)
    assert data == jax_pairwise
    assert data.count(b"\n") > 100
    assert st.ref_blocks == 2
    # max_hits cut most chunk-strands (three batches or more: the plan
    # always gives the last seed's hits a batch of their own)
    assert st.split_chunks > st.chunk_strands / 2
    assert st.hit_batches >= 3 * st.split_chunks


@pytest.mark.parametrize("route", ["native", "device_seeding"])
def test_rm_cli_batches_and_blocks_identical_to_jax(
        route, files, jax_rm, tmp_path, monkeypatch):
    data, st = _port("run_segalign_repeat_masker", [files[2], *RM], route,
                     tmp_path, monkeypatch)
    assert data == jax_rm
    assert data.count(b"\n") > 10
    assert st.ref_blocks == 3
    # max_hits cut every plus-strand chunk-strand (whose hits include each
    # position's hit on itself)
    assert st.split_chunks >= st.chunk_strands / 2
    assert st.hit_batches >= 3 * st.split_chunks


# ---- the per-program candidate compaction

def _random_fins(rng, n_prog=5, B=300):
    """Programs of B rows in ascending hit order, each row a candidate
    with probability 0.6, extents drawn from a small set (so exact
    duplicates fall within and across programs) at positions under 2^30,
    the JAX key's limit."""
    k = 120
    ext_rs = rng.integers(0, (1 << 30) - 1000, k)
    ext_qs = rng.integers(0, 1 << 20, k)
    ext_ln = rng.integers(1, 500, k)
    fins = []
    for _ in range(n_prog):
        e = rng.integers(0, k, B)
        fins.append(dict(
            candidate=rng.random(B) < 0.6,
            rs=ext_rs[e].astype(np.int32), qs=ext_qs[e].astype(np.int32),
            length=ext_ln[e].astype(np.int32),
            total=(ext_ln[e] * 7).astype(np.int32),
            counts=np.stack([ext_ln[e] + j for j in range(4)],
                            1).astype(np.int32)))
    return fins


def first_of_runs_plain(cand, rs, qs, ln, seg, key=None):
    """pipeline/program.py first_of_runs in numpy, rows in order: every
    candidate but one whose candidate before it in the stable order of
    `key` (the JAX _pack_compact's (rs, qs) when None) is equal on rs,
    qs, the length and the batch."""
    if key is None:
        key = (rs.astype(np.int64) << 31) | qs
    order = np.argsort(np.where(cand, key, np.iinfo(np.int64).max),
                       kind="stable")
    keep = []
    for j, i in enumerate(order):
        p = order[j - 1] if j else None
        if cand[i] and not (p is not None and cand[p] and (
                rs[p], qs[p], ln[p], seg[p]) == (rs[i], qs[i], ln[i],
                                                  seg[i])):
            keep.append(i)
    return np.sort(np.array(keep, np.int64))


def buffers_for(seg_ends, cand_rows):
    """pipeline/program.py Buffers on the CPU with these batch ends and no
    seed slots, for appending programs' fields by hand."""
    from segalign_tpu_torch.pipeline.program import Buffers
    buf = Buffers(1, 8, cand_rows, "cpu")
    buf.seg_ends[:len(seg_ends)] = torch.from_numpy(seg_ends)
    return buf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_candidates_pack_equals_jax_pack(seed):
    """Each program's candidates less their duplicates appended to the
    chunk-strand's buffer, then the pack: the JAX
    _pack_compact(dedup_exact=True)'s rows in its order, with batch ends
    inside programs and on a program boundary."""
    import jax.numpy as jnp
    from segalign_tpu.pipeline.device import _pack_compact as jax_pack
    from segalign_tpu_torch.pipeline.program import (append_candidates,
                                                     pack_candidates)
    rng = np.random.default_rng(seed)
    B = 300
    fins = _random_fins(rng, B=B)
    n = B * len(fins)
    seg_ends = np.array([137, 2 * B, 2 * B + 5, 1111], np.int64)
    jfins = [{**{k: jnp.asarray(v) for k, v in f.items()},
              "orig": jnp.arange(i * B, (i + 1) * B, dtype=jnp.int32)}
             for i, f in enumerate(fins)]
    total, want = jax_pack(jfins, jnp.asarray(seg_ends), TBUF=n,
                           dedup_exact=True)
    want = np.asarray(want)[:int(total)]
    buf = buffers_for(seg_ends, n)
    for i, f in enumerate(fins):
        append_candidates(buf, {k: torch.from_numpy(v)
                                for k, v in f.items()},
                          torch.arange(i * B, (i + 1) * B,
                                       dtype=torch.int32))
    # the buffer holds each program's candidates only, in hit order
    rows = buf.rows[:int(buf.n)].numpy()
    orig = rows[:, 0]
    assert (np.diff(orig) > 0).all()
    assert all(fins[o // B]["candidate"][o % B] for o in orig)
    out, counts = pack_candidates(buf, n)
    kept, appended = counts.tolist()
    assert appended == len(rows)
    got = out[:kept].numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < sum(f["candidate"].sum() for f in fins)


def _small_aligner(**kw):
    from segalign_tpu_torch import bench_inputs
    from segalign_tpu_torch.io.encode import revcomp_codes
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    ref, query = bench_inputs.load_inputs(0.05, 0.05)
    al = DeviceAligner(**{**bench_inputs.aligner_settings("cpu"),
                          "chunk_size": 20_000, **kw})
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    return al, ref, query


def test_dispatch_rows_returns_candidate_rows_only():
    """The programs' buffer holds their candidates only, at their hit
    indices, with the fields extend_fields_program gives them, less each
    program's duplicates (first_of_runs on its hash of (rs, qs))."""
    from segalign_tpu_torch.native import ChunkSeeder
    from segalign_tpu_torch.ops.extend_fused import extend_fields_program
    from segalign_tpu_torch.pipeline.device import CONT_W, PAD
    from segalign_tpu_torch.pipeline.program import HASH_MUL
    al, _, _ = _small_aligner(HBUF=64)
    it, pt = al._host_tables
    # the hits on the host, from the host seeder
    ref_loc, query_loc, *_ = ChunkSeeder(
        al.chunk_size, al.kmer_size, al.transition).seed(
            al._q_fw_host, 0, 20_000, it, pt, al.shape_pos, al.seed_size,
            al.max_hits)
    assert len(ref_loc) > 3 * 64
    s = al._seed_chunk(0, 20_000, False, into=al._buffers())
    al._dispatch_rows(s)
    rows = al._buf.rows[:int(al._buf.n)].numpy()
    seg = np.searchsorted(s.seg_ends, np.arange(len(ref_loc)),
                          side="right")
    want = []
    n_cand = 0
    for g0 in range(0, len(ref_loc), 64):
        r, q = ref_loc[g0:g0 + 64], query_loc[g0:g0 + 64]
        full = {k: v.numpy() for k, v in extend_fields_program(
            al.ref_pad, al.q_fw, torch.from_numpy(r), torch.from_numpy(q),
            len(r), al.sub, al.xdrop, al.hspthresh, al.ref_len, al.q_len,
            pad=PAD, W=al.window, W_CONT=CONT_W).items()}
        sel = first_of_runs_plain(
            full["candidate"], full["rs"], full["qs"], full["length"],
            seg[g0:g0 + 64], key=(full["rs"].astype(np.int64) * HASH_MUL
                                  + full["qs"]) & 0x7FFFFFFF)
        assert full["candidate"][sel].all()
        want.append(np.column_stack(
            [g0 + sel] + [full[k][sel] for k in ("rs", "qs", "length",
                                                  "total", "counts")]))
        n_cand += int(full["candidate"].sum())
    np.testing.assert_array_equal(rows, np.concatenate(want))
    assert 0 < len(rows) <= n_cand < len(ref_loc)


# ---- the old block goes before the next comes

def _block_tensors(al):
    """Every array and tensor of the reference block an aligner holds."""
    from segalign_tpu_torch.parallel.multi import MultiDeviceAligner
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    if isinstance(al, MultiDeviceAligner):
        return [t for a in al.aligners for t in _block_tensors(a)]
    if isinstance(al, ShardedAligner):
        return [*al.index_shards, *al.pos_shards,
                *(s["ref"] for s in al._shared.values())]
    return [al.ref_pad, al._ref_host, *al._host_tables, al.index_table,
            al.pos_table]


@pytest.mark.parametrize("kind", ["native", "device", "farm2", "sharded2"])
def test_set_ref_lets_go_of_the_old_block(kind):
    """After a second set_ref, nothing of the first block is reachable."""
    from segalign_tpu_torch import bench_inputs
    from segalign_tpu_torch.parallel.multi import MultiDeviceAligner
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    ref, _ = bench_inputs.load_inputs(0.04, 0.01)
    kw = {**bench_inputs.aligner_settings("cpu"), "chunk_size": 20_000}
    al = {"native": lambda: DeviceAligner(**kw),
          "device": lambda: DeviceAligner(device_seeding=True, **kw),
          "farm2": lambda: MultiDeviceAligner(num_devices=2, **kw),
          "sharded2": lambda: ShardedAligner(num_devices=2, **kw)}[kind]()
    # the blocks as copies, so that no caller holds what the aligner took
    al.set_ref(ref[:20_000].copy())
    old = [weakref.ref(t) for t in _block_tensors(al)]
    assert len(old) >= 3
    al.set_ref(ref[20_000:].copy())
    gc.collect()
    assert [r for r in old if r() is not None] == []
    assert len(_block_tensors(al)) == len(old)


# ---- the launch count under threads

def test_count_launch_is_exact_under_threads():
    from segalign_tpu_torch.ops.launches import count_launch

    def fn():
        pass
    fn.launches = 0
    fn.launches_by_T = {}
    n, threads = 10**5, 8

    def work():
        for _ in range(n):
            count_launch(fn, 64)
    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert fn.launches == n * threads
    assert fn.launches_by_T == {64: n * threads}


def test_every_wrapper_counts_through_count_launch():
    """No wrapper keeps a bare `launches += 1` of its own."""
    ops = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "segalign_tpu_torch", "ops")
    for name in sorted(os.listdir(ops)):
        if name.endswith(".py"):
            with open(os.path.join(ops, name)) as f:
                src = f.read()
            assert "launches += 1" not in src or name == "launches.py", name
