"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: without a GPU every test here skips (the fixture decides,
at run time). The file imports no jax, so on a machine without it run:

    SEGALIGN_TEST_TPU=1 SEGALIGN_TEST_NO_DEFAULT_DEVICE=1 \
        python -m pytest -m cuda tests/test_torch_cuda.py

Every comparison is exact: the values are integers, or floats times 2."""

import numpy as np
import pytest
import torch

from segalign_tpu_torch.config import build_substitution_matrix
from segalign_tpu_torch.ops.extend3 import STATE_KEYS
from segalign_tpu_torch.ops.first_scan import (first_scan, first_scan_plain,
                                               first_scan_seq,
                                               first_scan_seq_plain)
from segalign_tpu_torch.ops.gather import (gather_rows, gather_rows_plain,
                                           gather_rows_tile)
from segalign_tpu_torch.ops.launches import launch_counts
from segalign_tpu_torch.ops.window_scan import (window_scan,
                                                window_scan_plain,
                                                window_scan_seq,
                                                window_scan_seq_plain)
from segalign_tpu_torch.ops.window_scan_wide import (window_scan_wide,
                                                     window_scan_wide_plain)
from segalign_tpu_torch.scripts._scaling_worker import launch_faults

pytestmark = pytest.mark.cuda

SUB = build_substitution_matrix(910).reshape(-1).astype(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _seq(rng, n, pad):
    """Padded uint8 sequence with a repeated core and walls (4, 5, 7)."""
    s = np.full(n + 2 * pad, 6, np.uint8)
    body = rng.integers(0, 4, n).astype(np.uint8)
    body[n // 2:n // 2 + 3000] = body[1000:4000]
    body[[500, 7000]] = 7
    body[900:930] = 4
    body[2000:2010] = 5
    s[pad:pad + n] = body
    return s


def _same(a, b):
    for k in STATE_KEYS:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


@pytest.mark.parametrize("W", [512, 1024, 2048])
def test_gather_rows(dev, W):
    rng = np.random.default_rng(W)
    seq = torch.from_numpy(rng.integers(0, 8, 300_001).astype(np.uint8))
    starts = rng.integers(-5000, 300_001, 4099).astype(np.int32)
    starts[:2] = [-1, 2**31 - 1]          # clamped at both ends
    s = torch.from_numpy(starts)
    want = gather_rows_plain(seq, s, W)
    got = gather_rows(seq.to(dev), s.to(dev), W)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("W", [1024, 512])   # 2 x the first window
@pytest.mark.parametrize("T", [64, 512])
def test_gather_rows_tile(dev, T, W):
    rng = np.random.default_rng(T)
    seq = torch.from_numpy(rng.integers(0, 8, 400_000).astype(np.uint8))
    sorted_ = np.sort(rng.integers(0, 50_000, 3000))       # fits T=64
    clustered = 200_000 + rng.integers(0, 60_000, 1000)   # fits T=512
    wide = rng.integers(0, 400_000, 333)                    # fits no tile
    starts = torch.from_numpy(
        np.concatenate([sorted_, clustered, wide]).astype(np.int32))
    want = gather_rows_plain(seq, starts, W)
    got = gather_rows_tile(seq.to(dev), starts.to(dev), W, T)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W", [512, 256])   # the aligner's window widths
def test_first_scan(dev, W, with_counts):
    rng = np.random.default_rng(1 + with_counts)
    n, pad, B = 20_000, 1024, 5000
    seq = torch.from_numpy(_seq(rng, n, pad))
    loc_r = rng.integers(0, n, B).astype(np.int32)
    loc_q = loc_r.copy()
    loc_q[: B // 2] = rng.integers(0, n, B // 2)
    loc_r[B // 2:B // 2 + 1500] = rng.integers(1000, 4000, 1500)
    loc_q[B // 2:B // 2 + 1500] = loc_r[B // 2:B // 2 + 1500] + n // 2 - 1000
    loc_r[:4], loc_q[:4] = [0, n - 1, 3, 499], [n - 1, 0, 5, 499]
    # rows whose right (then left) window holds 0, 1, 255, 256, 257 and W
    # in-bounds lanes: the scan must not count a lane at or past the end,
    # nor read the other half's bytes
    ends = np.array([0, 1, 255, 256, 257, W])
    loc_r[4:16] = loc_q[4:16] = np.concatenate([n - ends, ends])
    valid = rng.random(B) > 0.1
    valid[4:16] = True
    lr, lq = torch.from_numpy(loc_r), torch.from_numpy(loc_q)
    r2 = gather_rows_plain(seq, pad + lr - W, 2 * W)
    q2 = gather_rows_plain(seq, pad + lq - W, 2 * W)
    args = (lr, lq, torch.from_numpy(valid), torch.from_numpy(SUB))
    want = first_scan_plain(r2, q2, *args, 910, n, n, W=W,
                            with_counts=with_counts)
    got = first_scan(r2.to(dev), q2.to(dev), *(a.to(dev) for a in args),
                     910, n, n, W=W, with_counts=with_counts)
    for w, g in zip(want, got):
        _same(w, g)
    assert (~want[0]["done"]).sum() > 0


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W", [512, 256, 80, 2048])
@pytest.mark.parametrize("pad", [2048, 100])
def test_first_scan_seq(dev, pad, W, with_counts):
    """K1 on the padded sequences against its plain version (the gathers,
    then K1's plain version): anchors at every offset within a 16-byte
    block, within W of both ends of both sequences, on a repeated core,
    rows not valid; a pad under W (the clamp moves windows), sequences
    whose lengths are no multiple of 16 (the last block partial) and
    anchors whose window start wraps in int32. Then
    rows that never drop (both windows inside the copied core), the same
    rows at xdrop 0, one row alone, and 33 rows (one warp and one row of
    the next: B no multiple of 32)."""
    rng = np.random.default_rng([3, pad, W, with_counts])
    n_r, n_q, B = 20_003, 17_001, 5000
    ref, query = _seq(rng, n_r, pad), _seq(rng, n_q, pad)
    # the reference's [2100, 7000), between its Ns and its wall, again at
    # 8000 in the query
    query[pad + 8000:pad + 12900] = ref[pad + 2100:pad + 7000]
    ref, query = torch.from_numpy(ref), torch.from_numpy(query)
    loc_r = rng.integers(0, n_r + 1, B).astype(np.int32)
    loc_q = rng.integers(0, n_q + 1, B).astype(np.int32)
    loc_r[:64] = 5000 + np.arange(64)
    loc_q[:64] = 9000 + np.arange(64)[::-1]
    loc_r[64:1564] = rng.integers(2200, 6900, 1500)
    loc_q[64:1564] = loc_r[64:1564] + 5900
    edges = np.array([0, 1, 15, 16, 17, W - 1, W, W + 1])
    for k, (er, eq) in enumerate(((edges, edges[::-1]),
                                  (n_r - edges, n_q - edges),
                                  (edges, n_q - edges),
                                  (n_r - edges, edges))):
        loc_r[1600 + 8 * k:1608 + 8 * k] = er
        loc_q[1600 + 8 * k:1608 + 8 * k] = eq
    # pad + loc - W wraps in int32, up past 2^31 - 1 (where pad >= 2W)
    # and down past -2^31, and the window's start clamps; top is the
    # largest anchor whose lanes loc + p stay inside int32
    top = 2**31 - W
    loc_r[1640:1645] = [top, top - 3, -2**31, top, -2**31 + 7]
    loc_q[1640:1645] = [top - 5, top, 100, top, -2**31]
    valid = rng.random(B) > 0.1
    valid[:1700] = True
    args = [torch.from_numpy(a) for a in (loc_r, loc_q, valid)]
    sub = torch.from_numpy(SUB)
    kw = dict(pad=pad, W=W, with_counts=with_counts)
    want = first_scan_seq_plain(ref, query, *args, sub, 910, n_r, n_q, **kw)
    before = first_scan_seq.launches
    got = first_scan_seq(ref.to(dev), query.to(dev),
                         *(a.to(dev) for a in args), sub.to(dev), 910, n_r,
                         n_q, **kw)
    assert first_scan_seq.launches == before + 1
    for w, g in zip(want, got):
        _same(w, g)
    assert (~want[0]["done"]).sum() > 0 and (~want[1]["done"]).sum() > 0

    # both windows of these rows lie in the reference's [2100, 7000) and
    # its copy in the query: equal windows, no drop
    still = np.linspace(2100 + W, 7000 - W, 160).astype(np.int32)
    rows = [torch.from_numpy(a) for a in (
        np.concatenate([still, loc_r[:200]]),
        np.concatenate([still + 5900, loc_q[:200]]),
        np.concatenate([np.ones(160, bool), valid[:200]]))]
    for n, xdrop in ((360, 910), (360, 0), (1, 910), (33, 910), (33, 0)):
        part = [a[:n] for a in rows]
        want = first_scan_seq_plain(ref, query, *part, sub, xdrop, n_r, n_q,
                                    **kw)
        got = first_scan_seq(ref.to(dev), query.to(dev),
                             *(a.to(dev) for a in part), sub.to(dev), xdrop,
                             n_r, n_q, **kw)
        for w, g in zip(want, got):
            _same(w, g)
        if xdrop == 910:   # the equal windows ran to their end
            for w in want:
                assert not w["done"][:min(n, 160)].any()


# ---- K4s: the survivors of both directions walked to their ends

def _k4s_inputs(rng, n_r, n_q, pad, B, first_w, core):
    """Padded sequences of random bases whose query holds two copies of
    `core`-long stretches of the reference: one at 1000 in the reference
    and 1011 in the query (r and q at different offsets mod 16), one at
    the reference's start that ends the query; walls, N and soft-masked
    runs outside the copies. B anchors: random ones (window starts at every
    offset mod 16 in r and q), anchors inside both copies (rows that walk
    up to core / W windows and run into the query's end or the
    reference's start), anchors within W of both ends of both sequences
    and of the copies' ends. The states first_scan_seq_plain leaves at
    `first_w`, with a third of the other rows set alive in carried states
    (some already past the drop)."""
    seqs = []
    for n in (n_r, n_q):
        s = np.full(n + 2 * pad, 6, np.uint8)
        s[pad:pad + n] = rng.integers(0, 4, n)
        seqs.append(s)
    ref, query = seqs
    a0, b0, b1 = 1000, 1011, n_q - core
    assert b1 >= b0 + core + 400 and n_r >= a0 + core + 400
    query[pad + b0:pad + b0 + core] = ref[pad + a0:pad + a0 + core]
    query[pad + b1:pad + n_q] = ref[pad:pad + core]
    for s, lo, hi in ((ref, a0 + core + 100, n_r),
                      (query, b0 + core + 100, b1 - 100)):
        at = pad + rng.integers(lo, hi - 40, 3)
        s[at[0]] = 7
        s[at[1]:at[1] + 30] = 4
        s[at[2]:at[2] + 10] = 5
    loc_r = rng.integers(0, n_r + 1, B).astype(np.int32)
    loc_q = rng.integers(0, n_q + 1, B).astype(np.int32)
    k = min(B // 4, 400)
    t = rng.integers(0, core, k)
    loc_r[:k // 2], loc_q[:k // 2] = a0 + t[:k // 2], b0 + t[:k // 2]
    loc_r[k // 2:k], loc_q[k // 2:k] = t[k // 2:], b1 + t[k // 2:]
    edges = np.array([0, 1, 15, 16, 17, first_w - 1, first_w, first_w + 1,
                      core - 1])
    e = len(edges)
    fixed = k
    if B >= k + 4 * e:
        fixed = k + 4 * e
        loc_r[k:k + e], loc_q[k:k + e] = edges, n_q - edges
        loc_r[k + e:k + 2 * e], loc_q[k + e:k + 2 * e] = n_r - edges, edges
        loc_r[k + 2 * e:k + 3 * e] = edges
        loc_q[k + 2 * e:k + 3 * e] = b1 + edges
        loc_r[k + 3 * e:fixed] = a0 + core - 1 - edges
        loc_q[k + 3 * e:fixed] = b0 + core - 1 - edges
    valid = rng.random(B) > 0.05
    valid[:fixed] = True
    seqs = torch.from_numpy(ref), torch.from_numpy(query)
    lr, lq = torch.from_numpy(loc_r), torch.from_numpy(loc_q)
    sub = torch.from_numpy(SUB)
    st_r, st_l = first_scan_seq_plain(*seqs, lr, lq, torch.from_numpy(valid),
                                      sub, 910, n_r, n_q, pad=pad, W=first_w,
                                      with_counts=True)
    for st in (st_r, st_l):
        carried = np.nonzero(rng.random(B) < 0.33)[0]
        c = torch.from_numpy(carried[carried >= fixed])
        cum = torch.from_numpy(rng.integers(-300, 4000, c.numel()).astype(
            np.int32))
        st["done"][c] = False
        st["cum"][c] = cum
        st["maxv"][c] = cum + torch.from_numpy(
            rng.integers(0, 1000, c.numel()).astype(np.int32))
        st["maxp"][c] = torch.from_numpy(
            rng.integers(0, first_w + 1, c.numel()).astype(np.int32))
    return seqs, lr, lq, (st_r, st_l), sub


def _k4s_check(dev, seqs, lr, lq, states, sub, n_r, n_q, *, pad, tile, W,
               with_counts, xdrop=910):
    """window_scan_seq on the card against its plain version on the CPU,
    from the same states; one launch. Returns the plain version's states
    and the rows alive on entry of each direction."""
    alive = [int((~st["done"]).sum()) for st in states]
    want = window_scan_seq_plain(*seqs, lr, lq,
                                 *({k: v.clone() for k, v in st.items()}
                                   for st in states), sub, xdrop, n_r, n_q,
                                 pad=pad, tile=tile, W=W,
                                 with_counts=with_counts)
    got = [{k: v.to(dev) for k, v in st.items()} for st in states]
    before = window_scan_seq.launches
    out = window_scan_seq(*(s.to(dev) for s in seqs), lr.to(dev), lq.to(dev),
                          *got, sub.to(dev), xdrop, n_r, n_q, pad=pad,
                          tile=tile, W=W, with_counts=with_counts)
    torch.cuda.synchronize()
    assert window_scan_seq.launches == before + 1
    for w, g, o in zip(want, got, out):
        assert o is g                      # updated in place
        _same(w, g)
        assert bool(w["done"].all())
    return want, alive


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W,tile", [(2048, 512), (80, 256)])
def test_window_scan_seq(dev, W, tile, with_counts):
    """K4s against its plain version: random anchors (window starts at
    every offset mod 16 in r and q), rows that walk 50 windows or more
    along a copied stretch, rows that run into either end of either
    sequence, carried states, rows past the drop on entry."""
    rng = np.random.default_rng([4, W, tile, with_counts])
    core = 60 * W + 1000
    n_r, n_q, pad, B = core + 30_003, 2 * core + 20_001, 2048, 3001
    seqs, lr, lq, states, sub = _k4s_inputs(rng, n_r, n_q, pad, B, tile,
                                            core)
    want, alive = _k4s_check(dev, seqs, lr, lq, states, sub, n_r, n_q,
                             pad=pad, tile=tile, W=W,
                             with_counts=with_counts)
    assert min(alive) > 200
    # rows that walked 50 windows or more, both ways
    for w in want:
        assert int((w["maxp"] >= tile + 50 * W).sum()) > 20
    # rows whose right extension ran to the query's last base, and left
    # ones to the reference's first
    assert bool((want[0]["maxp"] == n_q - 1 - lq).any())
    assert bool((want[1]["maxp"] == lr).any())


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("B", [1, 33, 129, 1000])
@pytest.mark.parametrize("alive", ["none", "one", "all"])
def test_window_scan_seq_batches(dev, alive, B, with_counts):
    """No row alive, one row alive and every row alive, at B not a
    multiple of 32 or of the 128 rows a claim takes; xdrop 0 as well."""
    rng = np.random.default_rng([5, len(alive), B, with_counts])
    n, pad, W, tile = 40_000, 2048, 2048, 512
    seqs, lr, lq, states, sub = _k4s_inputs(rng, n, n, pad, B, tile, 9000)
    for st in states:
        st["done"][:] = alive != "all"
        if alive == "one":
            st["done"][B // 2] = False
    for xdrop in (910, 0):
        _k4s_check(dev, seqs, lr, lq, states, sub, n, n, pad=pad, tile=tile,
                   W=W, with_counts=with_counts, xdrop=xdrop)


def test_window_scan_seq_two_streams(dev):
    """Launches on two streams at once, each with its own counters: every
    result equals the plain version's (the farm's two aligners share a
    card)."""
    rng = np.random.default_rng(6)
    n, pad, W, tile, B = 120_000, 2048, 2048, 512, 4000
    seqs, lr, lq, states, sub = _k4s_inputs(rng, n, n, pad, B, tile, 30_000)
    want = window_scan_seq_plain(*seqs, lr, lq,
                                 *({k: v.clone() for k, v in st.items()}
                                   for st in states), sub, 910, n, n,
                                 pad=pad, tile=tile, W=W, with_counts=False)
    d_seqs = [s.to(dev) for s in seqs]
    d_lr, d_lq, d_sub = lr.to(dev), lq.to(dev), sub.to(dev)
    copies = [[{k: v.to(dev) for k, v in st.items()} for st in states]
              for _ in range(8)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for i, c in enumerate(copies):
        with torch.cuda.stream(streams[i % 2]):
            window_scan_seq(*d_seqs, d_lr, d_lq, *c, d_sub, 910, n, n,
                            pad=pad, tile=tile, W=W, with_counts=False)
    torch.cuda.synchronize()
    for c in copies:
        for w, g in zip(want, c):
            _same(w, g)


def test_extend_fields_program_makes_no_host_sync(dev):
    """extend_fields_program on CUDA tensors under
    torch.cuda.set_sync_debug_mode("error"): K1s, K4s and finalize queue
    their work without waiting for the card; the fields equal the CPU's."""
    from segalign_tpu_torch.ops.extend_fused import extend_fields_program
    rng = np.random.default_rng(7)
    n, pad, B = 60_000, 2048, 3000
    seqs, lr, lq, _, sub = _k4s_inputs(rng, n, n, pad, B, 512, 20_000)
    args = (lr, lq, B - 7, sub)
    want = extend_fields_program(*seqs, *args, 910, 3000, n, n, pad=pad)
    d = [s.to(dev) for s in seqs] + [a.to(dev) if torch.is_tensor(a) else a
                                     for a in args]
    torch.cuda.synchronize()
    before = window_scan_seq.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = extend_fields_program(*d, 910, 3000, n, n, pad=pad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert window_scan_seq.launches == before + 1
    assert int(want["candidate"].sum()) > 10
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def _assert_engine_launched(since, ranges=None):
    """Since `since` (launch_counts), K1s and K4s launched (`ranges` times
    each, when given), and neither K2 nor K5."""
    n = launch_counts(since)
    assert not launch_faults(n), n
    if ranges is not None:
        assert n["first_scan_seq"] == n["window_scan_seq"] == ranges, n


def test_extend_hits_windowed_makes_no_host_sync(dev):
    """The device route's engine on CUDA tensors under
    torch.cuda.set_sync_debug_mode("error"), rows masked by `valid`: K1s,
    K4s and finalize queue their work without waiting for the card, once
    each; the fields equal the CPU's."""
    from segalign_tpu_torch.ops.extend3 import extend_hits_windowed
    rng = np.random.default_rng(8)
    n, pad, B = 60_000, 2048, 3000
    seqs, lr, lq, _, sub = _k4s_inputs(rng, n, n, pad, B, 512, 20_000)
    valid = torch.from_numpy(rng.random(B) > 0.1)
    args = (lr, lq, valid, sub)
    kw = dict(pad=pad, W=512, W_CONT=2048)
    want = extend_hits_windowed(*seqs, *args, 910, 3000, n, n, **kw)
    d = [t.to(dev) for t in (*seqs, *args)]
    torch.cuda.synchronize()
    since = launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = extend_hits_windowed(*d, 910, 3000, n, n, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _assert_engine_launched(since, ranges=1)
    assert int(want["candidate"].sum()) > 10
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_device_engine_on_the_card_equals_cpu_and_stepped(dev):
    """The device route's engine (K1s, then K4s, counts on) on the card at
    B = 2^17, on the first hit range of chunk 0's forward strand of the
    repeat pair with the rows outside an RM window masked: equal to its
    CPU version, and to the stepped check engine (K2 gathers and K5 steps
    at W = 2048) on the card, field for field."""
    from segalign_tpu_torch import bench_inputs
    from segalign_tpu_torch.io.encode import revcomp_codes
    from segalign_tpu_torch.ops.extend3 import (extend_hits_stepped,
                                                extend_hits_windowed)
    from segalign_tpu_torch.pipeline.device import (CONT_W, PAD,
                                                    DeviceAligner,
                                                    _range_hits)
    ref, query = bench_inputs.load_inputs()
    al = DeviceAligner(device_seeding=True,
                       **bench_inputs.aligner_settings(dev))
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    s = al._seed_chunk(0, bench_inputs.CHUNK, False, None)
    B = al.HBUF
    assert B == 1 << 17 and s.num_hits >= B
    ref_loc, query_loc, valid = _range_hits(
        al.pos_table, s.cum, s.starts, s.qpos, 0, B, al.seed_size,
        (500_000, 3_500_000))
    assert 0 < int(valid.sum()) < B
    args = (al.ref_pad, al.q_fw, ref_loc, query_loc, valid, al.sub,
            al.xdrop, al.hspthresh, al.ref_len, al.q_len)
    kw = dict(pad=PAD, W=al.window, W_CONT=CONT_W)
    since = launch_counts()
    got = extend_hits_windowed(*args, **kw)
    torch.cuda.synchronize()
    _assert_engine_launched(since, ranges=1)
    want = extend_hits_windowed(*(a.cpu() if torch.is_tensor(a) else a
                                  for a in args), **kw)
    before = (gather_rows.launches, window_scan_wide.launches)
    stepped = extend_hits_stepped(*args, pad=PAD, W=PAD)
    assert min(gather_rows.launches - before[0],
               window_scan_wide.launches - before[1]) > 0
    assert int(want["candidate"].sum()) > 0
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
        assert torch.equal(got[k], stepped[k]), k


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("left", [False, True])
def test_window_scan(dev, left, with_counts):
    rng = np.random.default_rng(10 + 2 * left + with_counts)
    n, pad, W, B, tile = 30_000, 4096, 2048, 3000, 512 + 2048
    seq = torch.from_numpy(_seq(rng, n, pad))
    loc_r = rng.integers(0, n, B).astype(np.int32)
    loc_q = rng.integers(0, n, B).astype(np.int32)
    loc_r[:4], loc_q[:4] = [0, n - 1, 3000, 100], [n - 1, 0, 2990, 7100]
    lr, lq = torch.from_numpy(loc_r), torch.from_numpy(loc_q)
    off = -tile - W if left else tile
    r = gather_rows_plain(seq, pad + lr + off, W)
    q = gather_rows_plain(seq, pad + lq + off, W)
    cum = rng.integers(-500, 5000, B).astype(np.int32)
    st = dict(done=rng.random(B) < 0.2, cum=cum,
              maxv=cum + rng.integers(0, 950, B).astype(np.int32),
              maxp=rng.integers(0, tile + 2, B).astype(np.int32),
              counts=rng.integers(0, 50, (B, 4)).astype(np.int32),
              cdel=rng.integers(0, 50, (B, 4)).astype(np.int32))
    st = {k: torch.from_numpy(v) for k, v in st.items()}
    sub = torch.from_numpy(SUB)
    want = window_scan_plain(r, q, lr, lq, st, sub, 910, tile, n, n, W=W,
                             left=left, with_counts=with_counts)
    got = window_scan(r.to(dev), q.to(dev), lr.to(dev), lq.to(dev),
                      {k: v.to(dev) for k, v in st.items()}, sub.to(dev),
                      910, tile, n, n, W=W, left=left,
                      with_counts=with_counts)
    _same(want, got)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("tile", [0, 2048])
@pytest.mark.parametrize("left", [False, True])
def test_window_scan_wide(dev, left, tile, with_counts):
    """K5 on windows in extension order, walls included: at tile 0 from a
    fresh state, and at tile > 0 from carried states, half alive."""
    from segalign_tpu_torch.ops.extend3 import init_state
    rng = np.random.default_rng(20 + 4 * left + 2 * bool(tile) + with_counts)
    n, pad, W, B = 30_000, 4096, 2048, 3000
    seq = torch.from_numpy(_seq(rng, n, pad))
    loc_r = rng.integers(0, n, B).astype(np.int32)
    loc_q = loc_r.copy()
    loc_q[: B // 2] = rng.integers(0, n, B // 2)
    loc_r[B // 2:B // 2 + 800] = rng.integers(1000, 4000, 800)
    loc_q[B // 2:B // 2 + 800] = loc_r[B // 2:B // 2 + 800] + n // 2 - 1000
    loc_r[:4], loc_q[:4] = [0, n - 1, 3000, 100], [n - 1, 0, 2990, 7100]
    lr, lq = torch.from_numpy(loc_r), torch.from_numpy(loc_q)
    off = -tile - W if left else tile
    r = gather_rows_plain(seq, pad + lr + off, W)
    q = gather_rows_plain(seq, pad + lq + off, W)
    if left:
        r, q = r.flip(1).contiguous(), q.flip(1).contiguous()
    if tile == 0:
        st = init_state(B, 0 if left else -1,
                        torch.from_numpy(rng.random(B) > 0.1), "cpu")
    else:
        cum = rng.integers(-500, 5000, B).astype(np.int32)
        st = dict(done=rng.random(B) < 0.5, cum=cum,
                  maxv=cum + rng.integers(0, 950, B).astype(np.int32),
                  maxp=rng.integers(0, tile + 2, B).astype(np.int32),
                  counts=rng.integers(0, 50, (B, 4)).astype(np.int32),
                  cdel=rng.integers(0, 50, (B, 4)).astype(np.int32))
        st = {k: torch.from_numpy(v) for k, v in st.items()}
    sub = torch.from_numpy(SUB)
    want = window_scan_wide_plain(r, q, lr, lq, st, sub, 910, tile, n, n,
                                  W=W, left=left, with_counts=with_counts)
    before = window_scan_wide.launches
    got = window_scan_wide(r.to(dev), q.to(dev), lr.to(dev), lq.to(dev),
                           {k: v.to(dev) for k, v in st.items()},
                           sub.to(dev), 910, tile, n, n, W=W, left=left,
                           with_counts=with_counts)
    assert window_scan_wide.launches == before + 1
    _same(want, got)


def _rm_aligner_pair(dev, **extra):
    from segalign_tpu.config import make_seed_config
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    sc = make_seed_config("12of19")
    kw = dict(shape_pos=sc.shape_pos, seed_size=sc.size, transition=True,
              step=1, sub_mat=build_substitution_matrix(910), xdrop=910,
              hspthresh=3000, noentropy=False, chunk_size=20_000,
              HBUF=4096, **extra)
    return sc, [DeviceAligner(device=d, **kw) for d in ("cpu", dev)]


@pytest.mark.parametrize("rm_mode", [False, True])
def test_device_seeding_aligner_cuda_matches_cpu(dev, rm_mode):
    """The device-seeding route on the card against the same route on the
    CPU; in rm_mode a self-alignment with a window. The card's run
    launches K1s and K4s and neither K2 nor K5."""
    from segalign_tpu.io.blocks import chunk_interval
    rng = np.random.default_rng(6)
    ref = rng.integers(0, 4, 60_000).astype(np.uint8)
    if rm_mode:
        ref[30_000:36_000] = ref[2000:8000]
        # soft-masked runs end the self-hits of the main diagonal
        for p in range(1000, 60_000, 2500):
            ref[p:p + 50] = 4
        query = ref
    else:
        query = rng.integers(0, 4, 60_000).astype(np.uint8)
        mut = rng.random(9000) < 0.08
        query[20_000:29_000] = np.where(mut, (ref[1000:10_000] + 1) % 4,
                                        ref[1000:10_000])
    qrc = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)[query[::-1]]
    sc, als = _rm_aligner_pair(dev, rm_mode=rm_mode, device_seeding=True)
    for al in als:
        al.set_ref(ref)
        al.set_query(query, qrc)
    window = (1000, 50_000) if rm_mode else None
    since = launch_counts()
    n = 0
    for (cs, ce) in chunk_interval(0, len(query) - sc.size, 20_000):
        for rev in (False, True):
            a, b = (al.seed_and_filter(cs, ce, rev, window=window)
                    for al in als)
            assert (a.num_hits, a.num_seeds) == (b.num_hits, b.num_seeds)
            np.testing.assert_array_equal(a.hsps, b.hsps)
            n += len(a.hsps)
    assert n > 0
    _assert_engine_launched(since)


def test_window_256_on_the_card_equals_512(dev):
    """Both strands of every chunk of a 1 Mbp slice of the bench pair on
    the card: the first window at 256 gives the HSPs of 512."""
    from segalign_tpu_torch import bench, bench_inputs
    from segalign_tpu_torch.io.encode import revcomp_codes
    ref, query = (x[:1_000_000] for x in bench_inputs.load_inputs())
    qrc = revcomp_codes(query)
    work = bench_inputs.chunk_work(query)
    out = {}
    for w in (256, 512):
        al = bench.make_aligner(dev, window=w)
        al.set_ref(ref)
        al.set_query(query, qrc)
        first_scan_seq.launches = 0
        out[w] = al.map_chunks(work)
        assert first_scan_seq.launches > 0
    assert sum(len(r.hsps) for r in out[512]) > 0
    for a, b in zip(out[256], out[512]):
        assert (a.num_hits, a.num_seeds) == (b.num_hits, b.num_seeds)
        np.testing.assert_array_equal(a.hsps, b.hsps)


def test_bench_run_config_on_the_card_equals_the_cpu(dev, tmp_path,
                                                     monkeypatch):
    """The port's bench.run_config at 0.3 x 0.2 Mbp: seeds, hits, HSPs and
    every chunk-strand's array on the card equal the CPU's."""
    from segalign_tpu_torch import bench, bench_inputs
    ref, query = bench_inputs.load_inputs(0.3, 0.2)
    out = {}
    for d in ("cpu", dev):
        path = str(tmp_path / f"{d}.npz")
        monkeypatch.setenv("BENCH_SAVE_HSPS", path)
        res = bench.run_config(ref, query, "repeat-1x", d)
        with np.load(path) as z:
            out[str(d)] = (res["stats"], {k: z[k] for k in z.files})
        if d == dev:
            assert res["launches"]["first_scan_seq"] > 0
            assert res["peak_bytes"] > 0
    (want, want_h), (got, got_h) = out["cpu"], out[str(dev)]
    assert got == want and want["hsps"] > 0
    assert got_h.keys() == want_h.keys()
    for k in want_h:
        np.testing.assert_array_equal(got_h[k], want_h[k], err_msg=k)


def test_aligner_cuda_matches_cpu(dev):
    from segalign_tpu.config import make_seed_config
    from segalign_tpu.io.blocks import chunk_interval
    from segalign_tpu_torch.ops import first_scan as fs_mod
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    rng = np.random.default_rng(5)
    sc = make_seed_config("12of19")
    ref = rng.integers(0, 4, 60_000).astype(np.uint8)
    query = rng.integers(0, 4, 60_000).astype(np.uint8)
    for src, dst, ln in ((1000, 20_000, 9000), (30_000, 45_000, 6000)):
        mut = rng.random(ln) < 0.08
        query[dst:dst + ln] = np.where(mut, (ref[src:src + ln] + 1) % 4,
                                       ref[src:src + ln])
    qrc = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)[query[::-1]]
    kw = dict(shape_pos=sc.shape_pos, seed_size=sc.size, transition=True,
              step=1, sub_mat=build_substitution_matrix(910), xdrop=910,
              hspthresh=3000, noentropy=False, chunk_size=20_000,
              HBUF=4096)
    als = [DeviceAligner(device=d, **kw) for d in ("cpu", dev)]
    for al in als:
        al.set_ref(ref)
        al.set_query(query, qrc)
    before = fs_mod.first_scan_seq.launches
    n = 0
    for (cs, ce) in chunk_interval(0, len(query) - sc.size, 20_000):
        for rev in (False, True):
            a, b = (al.seed_and_filter(cs, ce, rev) for al in als)
            assert a.num_hits == b.num_hits
            np.testing.assert_array_equal(a.hsps, b.hsps)
            n += len(a.hsps)
    assert n > 0 and fs_mod.first_scan_seq.launches > before


def _variant_inputs(rng, W, n, order):
    """A sequence of n + AW codes and 40_003 starts in [0, n] (not a
    multiple of the rows of a bank, and enough row blocks that every
    block loops), with both ends and 1024 boundaries among them."""
    from segalign_tpu_torch.ops.gather_variants import awin_for
    seq = rng.integers(0, 8, n + awin_for(W)).astype(np.uint8)
    starts = rng.integers(0, n + 1, 40_003).astype(np.int32)
    starts[:6] = [0, n, 1024, 1023, 1025, n - 1]
    if order == "sorted":
        starts.sort()
    return seq, starts


@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("W", [512, 2048])
@pytest.mark.parametrize("mode", ["dma_only", "extract_only", "dbuf"])
def test_gather_variants_s1(dev, mode, W, order):
    from segalign_tpu_torch.ops import gather_variants as gv
    fn = getattr(gv, f"gather_{mode}")
    plain = getattr(gv, f"gather_{mode}_plain")
    rng = np.random.default_rng(
        [W, len(mode), int(order == "sorted")])
    seq, starts = (torch.from_numpy(a)
                   for a in _variant_inputs(rng, W, 700_000, order))
    before = fn.launches
    got = fn(seq.to(dev), starts.to(dev), W)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got.cpu(), plain(seq, starts, W))


@pytest.mark.parametrize("order", ["random", "sorted"])
def test_gather_two_sided_s2(dev, order):
    """S2 from sequences of different lengths."""
    from segalign_tpu_torch.ops.gather_variants import (
        gather_two_sided, gather_two_sided_plain)
    rng = np.random.default_rng(7 + (order == "sorted"))
    W = 512
    seq_r, st_r = _variant_inputs(rng, W, 300_000, order)
    seq_q, st_q = _variant_inputs(rng, W, 1_000_003, order)
    seq_r, seq_q = torch.from_numpy(seq_r), torch.from_numpy(seq_q)
    starts2 = torch.from_numpy(np.concatenate([st_r, st_q]))
    want = gather_two_sided_plain(seq_r, seq_q, starts2, W)
    before = gather_two_sided.launches
    got = gather_two_sided(seq_r.to(dev), seq_q.to(dev), starts2.to(dev), W)
    torch.cuda.synchronize()
    assert gather_two_sided.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("shape", [(256, 512), (8, 128), (1001,)])
def test_scale2(dev, shape):
    from segalign_tpu_torch.ops.probe import scale2, scale2_plain
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x.view(-1)[:3] = torch.tensor([0.0, -0.0, 1e-40])
    before = scale2.launches
    got = scale2(x.to(dev))
    torch.cuda.synchronize()
    assert scale2.launches == before + 1
    assert torch.equal(got.cpu(), scale2_plain(x))


# ---- the warp-per-row scans (K1, K4, K5) at their edges

EDGES = [0, 1, 15, 16, 17, 511, 512, 513]


def _edge_windows(rng, B, W, kind):
    """Random (B, W) window pairs: rows of every identity, clean rows that
    run through the window, walls, masked and N runs; and the table."""
    r = rng.integers(0, 4, (B, W)).astype(np.uint8)
    q = r.copy()
    mut = rng.random((B, W)) < rng.uniform(0.0, 0.5, (B, 1))
    q[mut] = rng.integers(0, 8, int(mut.sum()))
    r[B // 2:][rng.random((B - B // 2, W)) < 0.01] = 7
    q[30:40] = r[30:40]
    r[5:9, 30:40] = 4
    q[7:12, 20:28] = 5
    if kind == "default":
        sub = SUB
    elif kind == "ties":
        sub = rng.integers(-2, 3, 64).astype(np.int32)
    else:   # sums that wrap
        sub = rng.integers(-2**30, 2**30, 64).astype(np.int32)
    return r, q, sub


def _edge_anchors(rng, B, W, n, tile, left):
    """Anchors that put the in-bounds length of row i at EDGES[i], W - 1,
    W and W + 5, through the ref or the query in turn."""
    loc_r = rng.integers(tile + 2 * W, n - tile - 2 * W, B).astype(np.int32)
    loc_q = rng.integers(tile + 2 * W, n - tile - 2 * W, B).astype(np.int32)
    for i, e in enumerate(EDGES + [W - 1, W, W + 5]):
        (loc_r if i % 2 else loc_q)[i] = tile + e if left else n - tile - e
    return loc_r, loc_q


def _edge_state(rng, B, tile, kind):
    if kind == "wrap":
        cum = rng.integers(-2**31, 2**31, B).astype(np.int32)
        maxv = rng.integers(-2**31, 2**31, B).astype(np.int32)
    else:
        cum = rng.integers(-300, 4000, B).astype(np.int32)
        maxv = (cum + rng.integers(0, 800, B)).astype(np.int32)
        maxv[20:26] = cum[20:26] + 915     # past the drop on entry
        maxv[:3] = cum[:3] + 2000          # also where nothing is in bounds
    st = dict(done=rng.random(B) < 0.25, cum=cum, maxv=maxv,
              maxp=rng.integers(0, tile + 1, B).astype(np.int32),
              counts=rng.integers(0, 40, (B, 4)).astype(np.int32),
              cdel=rng.integers(0, 40, (B, 4)).astype(np.int32))
    st["done"][:40] = False
    return {k: torch.from_numpy(v) for k, v in st.items()}


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("kind", ["default", "ties", "wrap"])
@pytest.mark.parametrize("W", [512, 80])
def test_first_scan_edges(dev, W, kind, with_counts):
    """K1 with the in-bounds length of either half at every edge, B not a
    multiple of the rows a block holds, ties and sums that wrap."""
    rng = np.random.default_rng([1, W, len(kind), with_counts])
    B, n = 203, 50_000
    r2, q2, sub = _edge_windows(rng, B, 2 * W, kind)
    # right edges on rows 0.., left edges on rows 100..
    loc_r, loc_q = _edge_anchors(rng, B, W, n, 0, False)
    ll_r, ll_q = _edge_anchors(rng, B, W, n, 0, True)
    loc_r[100:120], loc_q[100:120] = ll_r[:20], ll_q[:20]
    xdrop = 3 if kind == "ties" else 910
    args = [torch.from_numpy(a) for a in (
        r2, q2, loc_r, loc_q, rng.random(B) > 0.1, sub)]
    args[4][:120] = True
    want = first_scan_plain(*args, xdrop, n, n, W=W, with_counts=with_counts)
    got = first_scan(*(a.to(dev) for a in args), xdrop, n, n, W=W,
                     with_counts=with_counts)
    for w, g in zip(want, got):
        _same(w, g)


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("kind", ["default", "ties", "wrap"])
@pytest.mark.parametrize("W", [2048, 592])
@pytest.mark.parametrize("name", ["window_scan", "window_scan_wide"])
def test_carried_scan_edges(dev, name, W, kind, left, with_counts):
    """K4 and K5 from carried states (some done, some already past the
    drop) with the in-bounds length at every edge."""
    fn, plain = ((window_scan, window_scan_plain) if name == "window_scan"
                 else (window_scan_wide, window_scan_wide_plain))
    rng = np.random.default_rng([2, len(name), W, len(kind), left,
                                 with_counts])
    B, n, tile = 203, 50_000, 2 * W
    r, q, sub = _edge_windows(rng, B, W, kind)
    loc_r, loc_q = _edge_anchors(rng, B, W, n, tile, left)
    st = _edge_state(rng, B, tile, kind)
    xdrop = 3 if kind == "ties" else 910
    args = [torch.from_numpy(a) for a in (r, q, loc_r, loc_q)]
    sub = torch.from_numpy(sub)
    want = plain(*args, st, sub, xdrop, tile, n, n, W=W, left=left,
                 with_counts=with_counts)
    got = fn(*(a.to(dev) for a in args),
             {k: v.to(dev) for k, v in st.items()}, sub.to(dev), xdrop, tile,
             n, n, W=W, left=left, with_counts=with_counts)
    _same(want, got)
    assert (want["done"] & ~st["done"]).any()


@pytest.mark.parametrize("name", ["first_scan", "window_scan",
                                  "window_scan_wide"])
@pytest.mark.parametrize("B", [0, 1, 7, 9])
def test_scan_tiny_batches_and_all_done(dev, name, B):
    """No rows, fewer rows than a block holds, and every row done."""
    rng = np.random.default_rng([3, len(name), B])
    W, n, tile = 512, 50_000, 1024
    sub = torch.from_numpy(SUB)
    lr = torch.from_numpy(rng.integers(3000, n - 3000, B).astype(np.int32))
    lq = torch.from_numpy(rng.integers(3000, n - 3000, B).astype(np.int32))
    if name == "first_scan":
        r2 = torch.from_numpy(rng.integers(0, 4, (B, 2 * W)).astype(np.uint8))
        for valid in (torch.ones(B, dtype=torch.bool),
                      torch.zeros(B, dtype=torch.bool)):
            args = (r2, r2.clone(), lr, lq, valid, sub)
            want = first_scan_plain(*args, 910, n, n, W=W, with_counts=True)
            got = first_scan(*(a.to(dev) for a in args), 910, n, n, W=W,
                             with_counts=True)
            for w, g in zip(want, got):
                _same(w, g)
        return
    fn, plain = ((window_scan, window_scan_plain) if name == "window_scan"
                 else (window_scan_wide, window_scan_wide_plain))
    r = torch.from_numpy(rng.integers(0, 4, (B, W)).astype(np.uint8))
    for all_done in (False, True):
        st = _edge_state(rng, 64, tile, "default")
        st = {k: v[:B].clone() for k, v in st.items()}
        st["done"][:] = all_done
        for left in (False, True):
            want = plain(r, r.clone(), lr, lq, st, sub, 910, tile, n, n, W=W,
                         left=left, with_counts=True)
            got = fn(r.to(dev), r.clone().to(dev), lr.to(dev), lq.to(dev),
                     {k: v.to(dev) for k, v in st.items()}, sub.to(dev), 910,
                     tile, n, n, W=W, left=left, with_counts=True)
            _same(want, got)


@pytest.mark.parametrize("name", ["first_scan", "window_scan",
                                  "window_scan_wide"])
def test_scan_full_batch(dev, name):
    """B = 2^17 rows (W = 512 for K1, 2048 for K4 and K5): the grid and the
    64-bit row offsets. Inputs are made on the card; the plain version
    runs there too."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, n = 1 << 17, 4_000_000
    W = 512 if name == "first_scan" else 2048
    width = 2 * W if name == "first_scan" else W
    r = torch.randint(0, 4, (B, width), generator=g, device=dev,
                      dtype=torch.uint8)
    q = torch.where(torch.rand((B, width), generator=g, device=dev)
                    < torch.rand((B, 1), generator=g, device=dev) * 0.4,
                    torch.randint(0, 8, (B, width), generator=g, device=dev,
                                  dtype=torch.uint8), r)
    lr = torch.randint(0, n, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    lq = torch.randint(0, n, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    sub = torch.from_numpy(SUB).to(dev)
    if name == "first_scan":
        valid = torch.rand(B, generator=g, device=dev) > 0.01
        want = first_scan_plain(r, q, lr, lq, valid, sub, 910, n, n, W=W,
                                with_counts=True)
        got = first_scan(r, q, lr, lq, valid, sub, 910, n, n, W=W,
                         with_counts=True)
        for w, gg in zip(want, got):
            _same(w, gg)
        return
    fn, plain = ((window_scan, window_scan_plain) if name == "window_scan"
                 else (window_scan_wide, window_scan_wide_plain))
    cum = torch.randint(-300, 4000, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    st = dict(done=torch.rand(B, generator=g, device=dev) < 0.3, cum=cum,
              maxv=cum + torch.randint(0, 800, (B,), generator=g, device=dev,
                                       dtype=torch.int32),
              maxp=torch.randint(0, W, (B,), generator=g, device=dev,
                                 dtype=torch.int32),
              counts=torch.randint(0, 40, (B, 4), generator=g, device=dev,
                                   dtype=torch.int32),
              cdel=torch.randint(0, 40, (B, 4), generator=g, device=dev,
                                 dtype=torch.int32))
    for left in (False, True):
        want = plain(r, q, lr, lq, st, sub, 910, W, n, n, W=W, left=left,
                     with_counts=True)
        got = fn(r, q, lr, lq, st, sub, 910, W, n, n, W=W, left=left,
                 with_counts=True)
        _same(want, got)
        del want, got


def test_every_launcher_counts_1000_launches(dev):
    """Each launcher called 1000 times through its wrapper:
    the count rises by 1000 and no launch is refused."""
    from segalign_tpu_torch.ops import gather_variants as gv
    from segalign_tpu_torch.ops.extend3 import init_state
    from segalign_tpu_torch.ops.probe import scale2
    rng = np.random.default_rng(11)
    B, W, n = 64, 512, 100_000
    seq = torch.from_numpy(rng.integers(0, 4, n + 4096).astype(np.uint8)
                           ).to(dev)
    starts = torch.from_numpy(rng.integers(0, n, B).astype(np.int32)).to(dev)
    loc = torch.from_numpy(rng.integers(W, n - W, B).astype(np.int32)).to(dev)
    sub = torch.from_numpy(SUB).to(dev)
    r2 = gather_rows(seq, loc - W, 2 * W)
    r = r2[:, W:].contiguous()
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    st = init_state(B, -1, valid, dev)
    done = init_state(B, -1, ~valid, dev)
    x = torch.ones(64, device=dev)
    kw = dict(W=W, left=False, with_counts=False)
    calls = [
        (gather_rows, lambda: gather_rows(seq, starts, W)),
        (gather_rows_tile, lambda: gather_rows_tile(seq, starts, W, 512)),
        (first_scan_seq, lambda: first_scan_seq(
            seq, seq, loc, loc, valid, sub, 910, n, n, pad=0, W=W,
            with_counts=False)),
        (first_scan, lambda: first_scan(r2, r2, loc, loc, valid, sub, 910, n,
                                        n, W=W, with_counts=False)),
        (window_scan, lambda: window_scan(r, r, loc, loc, st, sub, 910, 0, n,
                                          n, **kw)),
        (window_scan_wide, lambda: window_scan_wide(r, r, loc, loc, st, sub,
                                                    910, 0, n, n, **kw)),
        # every row done: the launch reads the flags and walks nothing
        (window_scan_seq, lambda: window_scan_seq(
            seq, seq, loc, loc, done, done, sub, 910, n, n, pad=0, tile=W,
            W=W, with_counts=False)),
        (gv.gather_dma_only, lambda: gv.gather_dma_only(seq, starts, W)),
        (gv.gather_extract_only,
         lambda: gv.gather_extract_only(seq, starts, W)),
        (gv.gather_dbuf, lambda: gv.gather_dbuf(seq, starts, W)),
        (gv.gather_two_sided, lambda: gv.gather_two_sided(
            seq, seq, torch.cat([starts, starts]), W)),
        (scale2, lambda: scale2(x)),
    ]
    for wrapper, call in calls:
        before = wrapper.launches
        for _ in range(1000):
            call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1000, wrapper.__name__


# ---- the staged gathers (K3, S1) at their edges

def _tile_starts(rng, B, L, W, width):
    """Tiles of 128 rows whose windows fit `width` bytes, at random
    places."""
    tiles = -(-B // 128)
    base = rng.integers(0, max(L - width, 1), tiles)
    return (np.repeat(base, 128)[:B]
            + rng.integers(0, max(width - W, 1), B)).astype(np.int32)


def _tile_check(dev, seq, starts, W, T):
    """gather_rows_tile on the card against the plain version there."""
    before = gather_rows_tile.launches
    got = gather_rows_tile(seq, starts, W, T)
    torch.cuda.synchronize()
    assert gather_rows_tile.launches == before + 1
    assert got.shape == (starts.numel(), W) and got.dtype == torch.uint8
    assert torch.equal(got, gather_rows_plain(seq, starts, W))


@pytest.mark.parametrize("T", [1, 64, 512, 1024])
@pytest.mark.parametrize("B", [0, 1, 127, 128, 129, 1 << 17])
def test_gather_rows_tile_batches(dev, B, T):
    """No rows, one short tile, a whole one, one row more, and 2^17 rows
    (more tiles than the card holds blocks, so blocks walk several), at
    every stage size: T = 1 fits no window of 1024 (every row direct),
    T = 1024 is capped at 96 KB a stage."""
    rng = np.random.default_rng([B, T])
    L, W = 3_000_001, 1024
    seq = torch.from_numpy(rng.integers(0, 256, L).astype(np.uint8)).to(dev)
    starts = _tile_starts(rng, B, L, W, max(T * 128 - 32, W + 1))
    starts[5::1000] = rng.integers(-2000, L + 2000, len(starts[5::1000]))
    _tile_check(dev, seq, torch.from_numpy(starts).to(dev), W, T)


@pytest.mark.parametrize("m", [0, 1, 15])
@pytest.mark.parametrize("W", [4, 8, 16, 20, 1024, 2048])
@pytest.mark.parametrize("kind", ["clustered", "unclustered", "clamped"])
def test_gather_rows_tile_widths(dev, kind, W, m):
    """The 4-byte and the 16-byte routes, the sequence a view `m` bytes
    off its storage's 16-byte boundary, of a length that is no multiple of
    16; starts that cluster, that do not, and that the clamp moves."""
    rng = np.random.default_rng([W, m, len(kind)])
    L, B, T = 500_003, 3000, 64
    base = torch.from_numpy(rng.integers(0, 256, L + m).astype(np.uint8))
    seq = base.to(dev)[m:]
    assert seq.data_ptr() % 16 == m
    if kind == "clustered":
        starts = _tile_starts(rng, B, L, W, T * 128 - 32)
    elif kind == "unclustered":
        starts = rng.integers(0, L - W, B).astype(np.int32)
        starts[::128] = 0
        starts[1::128] = L - W
    else:
        starts = rng.integers(-3000, L + 3000, B).astype(np.int32)
        starts[:4] = [-1, -2**31, 2**31 - 1, L - W + 1]
        starts[130:134] = [0, L - W, L - W - 1, 1]
    _tile_check(dev, seq, torch.from_numpy(starts).to(dev), W, T)


@pytest.mark.parametrize("lo_mod", [0, 1, 15])
@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("T", [1, 64, 512])
def test_gather_rows_tile_span_at_the_cap(dev, T, delta, lo_mod):
    """Tiles whose span is exactly T x 128 bytes, one under and one over,
    from an aligned and an unaligned first byte."""
    rng = np.random.default_rng([T, delta + 1, lo_mod])
    W = 1024 if T > 8 else 16
    L = 400_000
    seq = torch.from_numpy(rng.integers(0, 256, L).astype(np.uint8)).to(dev)
    lo = 4096 + lo_mod
    hi = lo + T * 128 - W + delta
    s = rng.integers(lo, hi + 1, 128)
    s[[3, 77]] = [hi, lo]
    starts = np.concatenate([s, s[::-1] + 200_000, s[:5]] * 40)
    _tile_check(dev, seq, torch.from_numpy(starts.astype(np.int32)).to(dev),
                W, T)


@pytest.mark.parametrize("m", [0, 1, 8, 15])
@pytest.mark.parametrize("L", [16, 17, 31, 32, 33, 64, 100])
def test_gather_rows_tile_short_sequences(dev, L, m):
    """Sequences of a few 16-byte words: the clipped stage can be empty."""
    rng = np.random.default_rng([L, m])
    seq = torch.from_numpy(
        rng.integers(0, 256, L + m).astype(np.uint8)).to(dev)[m:]
    starts = torch.from_numpy(
        rng.integers(-5, L + 5, 140).astype(np.int32)).to(dev)
    for W in (4, 16):
        _tile_check(dev, seq, starts, W, 1)


@pytest.mark.parametrize("B", [1, 7, 8, 9, 15, 16, 17, 63, 65, 40_003])
@pytest.mark.parametrize("W", [16, 512, 2048])
@pytest.mark.parametrize("mode", ["dma_only", "extract_only", "dbuf"])
def test_gather_variants_s1_offsets(dev, mode, W, B):
    """S1 with starts at offsets 0, 1, 15, 16 and 1023 of a 1024-byte
    slice and at both ends of the admitted range, B around a bank's rows
    (8 or 16) and the row blocks a block walks."""
    from segalign_tpu_torch.ops import gather_variants as gv
    fn = getattr(gv, f"gather_{mode}")
    plain = getattr(gv, f"gather_{mode}_plain")
    rng = np.random.default_rng([W, len(mode), B])
    L = 200_000 + gv.awin_for(W)
    hi = L - gv.awin_for(W)
    seq = torch.from_numpy(rng.integers(0, 256, L).astype(np.uint8)).to(dev)
    starts = rng.integers(0, hi + 1, B).astype(np.int32)
    edges = [hi, 0, 1, 15, 16, 1023, 1024, 2048 + 15, 4096 + 1023, hi - 1,
             hi - 15, hi - 16]
    starts[:len(edges)] = edges[:B]
    starts = torch.from_numpy(starts).to(dev)
    before = fn.launches
    got = fn(seq, starts, W)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(seq, starts, W))


def test_staged_gathers_1000_launches_on_a_side_stream(dev):
    """K3 at both of the path's T and S1's three modes, 1000 launches each
    in a row on a stream of the caller's: the last output is right, so the
    two stages and their barriers hold from launch to launch."""
    from segalign_tpu_torch.ops import gather_variants as gv
    rng = np.random.default_rng(12)
    L, B = 600_000, 4000
    seq = torch.from_numpy(rng.integers(0, 256, L).astype(np.uint8)).to(dev)
    tiled = torch.from_numpy(_tile_starts(rng, B, L, 1024, 8000)).to(dev)
    free = torch.from_numpy(
        rng.integers(0, L - 4096, B).astype(np.int32)).to(dev)
    calls = [
        (gather_rows_tile, lambda: gather_rows_tile(seq, tiled, 1024, 64),
         lambda: gather_rows_plain(seq, tiled, 1024)),
        (gather_rows_tile, lambda: gather_rows_tile(seq, tiled, 1024, 512),
         lambda: gather_rows_plain(seq, tiled, 1024)),
        (gv.gather_dma_only, lambda: gv.gather_dma_only(seq, free, 512),
         lambda: gv.gather_dma_only_plain(seq, free, 512)),
        (gv.gather_extract_only,
         lambda: gv.gather_extract_only(seq, free, 512),
         lambda: gv.gather_extract_only_plain(seq, free, 512)),
        (gv.gather_dbuf, lambda: gv.gather_dbuf(seq, free, 512),
         lambda: gv.gather_dbuf_plain(seq, free, 512)),
    ]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    for wrapper, call, plain in calls:
        before = wrapper.launches
        with torch.cuda.stream(side):
            for _ in range(1000):
                got = call()
        side.synchronize()
        assert wrapper.launches == before + 1000, wrapper.__name__
        assert torch.equal(got, plain()), wrapper.__name__
    by_T = gather_rows_tile.launches_by_T
    assert by_T[64] >= 1000 and by_T[512] >= 1000
    assert sum(by_T.values()) == gather_rows_tile.launches


def test_stream_of_is_the_current_stream(dev):
    """_build.stream_of reads the handle through a private torch function:
    it must give what the public API gives, on the default stream, under a
    stream of the caller's, and back on the default one after it."""
    from segalign_tpu_torch import _build

    def public():
        return torch.cuda.current_stream(dev).cuda_stream

    assert _build.stream_of(dev) == public()
    assert _build.stream_of(torch.device("cuda")) == public()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert _build.stream_of(dev) == public() == side.cuda_stream
        x = torch.arange(1 << 16, dtype=torch.float32, device=dev)
        from segalign_tpu_torch.ops.probe import scale2
        y = scale2(x)
    side.synchronize()
    assert torch.equal(y, x * 2)
    assert _build.stream_of(dev) == public() != side.cuda_stream


def _small_pair_work(chunk=20_000):
    """A 0.2 Mbp x 0.2 Mbp pair of the benchmark's generator, its aligner
    settings at a chunk size that gives twenty chunk-strands."""
    from segalign_tpu_torch import bench_inputs
    from segalign_tpu_torch.io.encode import revcomp_codes
    from segalign_tpu_torch.parallel.multi import ChunkWork
    ref, query = bench_inputs.load_inputs(0.2, 0.2)
    kw = dict(bench_inputs.aligner_settings("cuda:0"), chunk_size=chunk)
    q_len = len(query) - kw["seed_size"]
    work = [ChunkWork(cs, min(cs + chunk, q_len), rev)
            for cs in range(0, q_len, chunk) for rev in (False, True)]
    return ref, query, revcomp_codes(query), kw, work


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.num_hits, a.num_seeds) == (b.num_hits, b.num_seeds)
        np.testing.assert_array_equal(a.hsps, b.hsps)


@pytest.mark.parametrize("device_seeding", [False, True],
                         ids=["native", "device"])
def test_two_aligners_on_one_card_repeatedly(dev, device_seeding):
    """The farm with two aligners on cuda:0: two worker threads and their
    finishers launch and fetch on one stream; every run must give one
    aligner's arrays, and launch K1s and K4s (both routes' engine) and
    neither K2 nor K5."""
    from segalign_tpu_torch.parallel.multi import MultiDeviceAligner
    ref, query, qrc, kw, work = _small_pair_work()
    kw["device_seeding"] = device_seeding
    one = MultiDeviceAligner(num_devices=1, **kw)
    two = MultiDeviceAligner(num_devices=2, **kw)
    for al in (one, two):
        al.set_ref(ref)
        al.set_query(query, qrc)
    want = one.map_chunks(work)
    assert sum(len(r.hsps) for r in want) > 0
    since = launch_counts()
    chunks_by = np.zeros(2, np.int64)
    for _ in range(2 if device_seeding else 8):
        _assert_same_results(two.map_chunks(work, depth=2), want)
        # no failure that the requeue absorbed
        assert not two.errors and not two.dead
        chunks_by += two.chunks_by
    _assert_engine_launched(since)
    assert chunks_by.min() > 0 and chunks_by.sum() == len(work) * (
        2 if device_seeding else 8)


@pytest.mark.parametrize("max_hits", [10**9, 500])
def test_sharded_table_on_one_card(dev, max_hits):
    """Four shards on cuda:0 against the replicated device route, with one
    and with several hit batches a chunk-strand; the shards launch K1s and
    K4s and neither K2 nor K5."""
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    ref, query, qrc, kw, work = _small_pair_work()
    kw["max_hits"] = max_hits
    want_al = DeviceAligner(device_seeding=True, **kw)
    got_al = ShardedAligner(num_devices=4, **kw)
    for al in (want_al, got_al):
        al.set_ref(ref)
        al.set_query(query, qrc)
    want = want_al.map_chunks(work)
    assert sum(len(r.hsps) for r in want) > 0
    assert max(r.num_hits for r in want) > 2 * 500
    since = launch_counts()
    _assert_same_results(got_al.map_chunks(work), want)
    _assert_engine_launched(since)


def test_farm_and_shards_over_several_cards(dev):
    """--device cuda with every card of the machine: an aligner a card in
    the farm (both routes), shards round-robin over the cards; each must
    give one card's arrays. Skips on a machine with one card."""
    from segalign_tpu_torch.parallel.multi import MultiDeviceAligner
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    ref, query, qrc, kw, work = _small_pair_work()
    kw["device"] = "cuda"
    one = MultiDeviceAligner(num_devices=1, **kw)
    farms = [MultiDeviceAligner(num_devices=-1, device_seeding=ds, **kw)
             for ds in (False, True)]
    shards = ShardedAligner(num_devices=n, **kw)
    assert [a.device.index for a in farms[0].aligners] == list(range(n))
    assert {d.index for d in shards.devices} == set(
        range(min(n, shards.num_devices)))
    want = None
    for al in (one, *farms, shards):
        al.set_ref(ref)
        al.set_query(query, qrc)
        got = al.map_chunks(work)
        if want is None:
            want = got
            assert sum(len(r.hsps) for r in want) > 0
        _assert_same_results(got, want)


@pytest.mark.parametrize("rm", [False, True], ids=["pairwise", "rm"])
@pytest.mark.parametrize("device_seeding", [False, True],
                         ids=["native", "device"])
def test_farm_on_one_card_matches_jax_digest(dev, device_seeding, rm):
    """Two aligners on cuda:0 on the inputs of
    tests/test_torch_multidevice.py, against the digest of the JAX
    package's results that the CPU tests there check."""
    import test_torch_multidevice as cpu
    from segalign_tpu_torch.parallel.multi import MultiDeviceAligner
    ref, query, qrc, window = cpu.inputs(rm)
    farm = MultiDeviceAligner(device="cuda:0", num_devices=2, rm_mode=rm,
                              device_seeding=device_seeding,
                              **cpu.settings())
    farm.set_ref(ref)
    farm.set_query(query, qrc)
    got = farm.map_chunks(cpu.chunk_work(window), depth=2)
    assert cpu.digest(got) == cpu.JAX_SHA256[rm]
    assert not farm.errors and not farm.dead


def test_shards_on_one_card_match_jax_digests(dev):
    """Four shards on cuda:0 on every case of tests/test_torch_sharded.py
    (one and several hit batches, an RM window), against the digests of
    the JAX package's results that the CPU tests there check."""
    import test_torch_sharded as cpu
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    rc = np.array([3, 2, 1, 0, 4, 5, 6, 7], np.uint8)
    for key, want in cpu.JAX_SHA256.items():
        ref, query, work, kw = cpu.aligner_case(*key)
        al = ShardedAligner(device="cuda:0", num_devices=4, **kw)
        al.set_ref(ref)
        al.set_query(query, rc[query[::-1]])
        assert cpu.digest(al.map_chunks(work)) == want, key


@pytest.mark.parametrize("kind", ["native", "device", "sharded"])
def test_second_block_keeps_the_peak(dev, kind):
    """A second set_ref lets go of the first block before it uploads its
    own: the peak over two 20 Mbp blocks (on the device route an 80 MB
    position table each) stays within 10% of the peak over one."""
    from segalign_tpu_torch import bench_inputs
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    ref, _ = bench_inputs.load_inputs(40, 0.2)
    kw = bench_inputs.aligner_settings("cuda:0")
    al = (ShardedAligner(num_devices=2, **kw) if kind == "sharded"
          else DeviceAligner(device_seeding=kind == "device", **kw))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    al.set_ref(ref[:20_000_000])
    torch.cuda.synchronize()
    one = torch.cuda.max_memory_allocated() - base
    al.set_ref(ref[20_000_000:])
    torch.cuda.synchronize()
    two = torch.cuda.max_memory_allocated() - base
    assert one >= 20_000_000
    assert two <= 1.1 * one, (one, two)


_NCCL_WORKER = """
import torch
import torch.distributed as dist
from segalign_tpu_torch.parallel.distributed import \\
    maybe_initialize_distributed
host_id, num_hosts = maybe_initialize_distributed("cuda")
assert num_hosts == 2
assert dist.is_initialized() and dist.get_backend() == "nccl"
assert dist.get_world_size() == 2 and dist.get_rank() == host_id
x = torch.full((4,), host_id + 1, dtype=torch.int32, device="cuda")
dist.all_reduce(x)
assert x.tolist() == [3] * 4, x
assert maybe_initialize_distributed("cuda") == (host_id, 2)
dist.destroy_process_group()
print(f"WORKER_OK {host_id}")
"""


def test_two_process_nccl_rendezvous(dev, tmp_path):
    """Two hosts on CUDA, here two processes with a card each, join the
    NCCL group at SEGALIGN_COORD and reduce over it. Skips on a machine
    with one card."""
    import os
    import socket
    import subprocess
    import sys
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_NCCL_WORKER)
    procs = []
    for hid in range(2):
        env = dict(os.environ, PYTHONPATH=root, SEGALIGN_NUM_HOSTS="2",
                   SEGALIGN_HOST_ID=str(hid),
                   SEGALIGN_COORD=f"127.0.0.1:{port}",
                   CUDA_VISIBLE_DEVICES=str(hid), NCCL_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the NCCL workers timed out")
        outs.append((p.returncode, out, err))
    for hid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {hid} failed:\n{err[-2000:]}"
        assert f"WORKER_OK {hid}" in out


def test_two_processes_on_one_card_match_jax_digests(dev, tmp_path):
    """Two processes with two shards each on cuda:0, over a gloo group
    (NCCL takes one process a card; the collectives copy through host
    memory), on every case of tests/test_torch_sharded.py: each rank's
    results hash to the JAX package's digest, the short chunk-strands in
    which one rank seeds nothing equal four shards in one process on the
    card, and each worker launched K1s and K4s and neither K2 nor K5."""
    import test_torch_distributed_sharded as cpu
    from test_torch_sharded import JAX_SHA256
    got, job = cpu.run_two_ranks(tmp_path, "cuda:0")
    _, ref, query, work, kw = next(c for c in job["cases"]
                                   if c[0] == "short")
    want = cpu.in_process(ref, query, work, kw, "cuda:0")
    for rank in range(2):
        for key, digest in JAX_SHA256.items():
            assert cpu.digest([cpu.R(t) for t in got[rank]["cases"][key]]) \
                == digest, (rank, key)
        _assert_same_results([cpu.R(t) for t in got[rank]["cases"]["short"]],
                             want)
        assert got[rank]["host_staged"]
        assert not launch_faults(got[rank]["launches"])


def test_four_processes_over_nccl(dev, tmp_path):
    """Four processes, a card and a shard each, over NCCL on the 0.2 Mbp
    pair: every rank returns one card's arrays. Skips under four cards."""
    from segalign_tpu_torch.parallel.multi import MultiDeviceAligner
    from segalign_tpu_torch.scripts._scaling_worker import run_workers
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    ref, query, qrc, kw, work = _small_pair_work()
    one = MultiDeviceAligner(num_devices=1, **kw)
    one.set_ref(ref)
    one.set_query(query, qrc)
    want = one.map_chunks(work)
    assert sum(len(r.hsps) for r in want) > 0
    outs = run_workers(
        dict(mode="sharded", ref=ref, query=query, shards=1, runs=1,
             kw={k: v for k, v in kw.items() if k != "device"},
             work=[(w.chunk_start, w.chunk_end, w.rev, w.window)
                   for w in work]), 4, "cuda", str(tmp_path), timeout=400)
    for o in outs:
        assert (o["backend"], o["shards"], o["host_staged"]) == \
            ("nccl", 4, False)
        got = [(r.hsps, r.num_hits, r.num_seeds) for r in want]
        assert len(o["results"]) == len(got)
        for a, b in zip(o["results"], got):
            assert a[1:] == b[1:]
            np.testing.assert_array_equal(a[0], b[0])
        assert not launch_faults(o["launches"])


# ---- the native route's programs as CUDA graphs (pipeline/program.py)

def _program_snapshots(al, s, runner):
    """The native route's programs of a chunk-strand seeded into `al`'s
    buffers, each run by runner(rev), and (count, candidate rows) after
    each: _dispatch_rows with its runner swapped."""
    snaps = []

    def program(rev):
        run = runner(rev)

        def step(rows):
            run(rows)
            n = int(al._buf.n)
            snaps.append((n, al._buf.rows[:n].cpu()))
        return step

    al._program = program
    try:
        al._dispatch_rows(s)
    finally:
        del al._program
    return snaps


@pytest.mark.parametrize("window", [None, (60_000, 140_000)],
                         ids=["plain", "rm_window"])
def test_program_graph_replays_equal_the_eager_function(dev, window):
    """Every program of a chunk-strand of the 0.2 Mbp pair (about 2000
    hits) at HBUF = 512 (full programs and a partial last one; with an RM
    window, rows masked in each): the graph's replays give, program after
    program, the count and the rows of extend_program run eagerly on the
    card and on the CPU, and launch one K1s and one K4s a replay; the
    pack's graph gives the block and count of pack_candidates."""
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    from segalign_tpu_torch.pipeline.program import pack_candidates
    ref, query, qrc, kw, work = _small_pair_work()
    als = [DeviceAligner(**{**kw, "device": d, "HBUF": 512})
           for d in (dev, "cpu")]
    for al in als:
        al.set_ref(ref)
        al.set_query(query, qrc)
    for w in work[:4]:
        seeded = [al._seed_chunk(w.chunk_start, w.chunk_end, w.rev, window,
                                 into=al._buffers()) for al in als]
        n_hits = seeded[0].num_hits
        if n_hits <= 512 or n_hits % 512 == 0:
            continue
        since = launch_counts()
        graphed = _program_snapshots(als[0], seeded[0], als[0]._program)
        programs = -(-n_hits // 512)
        _assert_engine_launched(since, ranges=programs)
        eager = _program_snapshots(
            als[0], seeded[0], lambda rev: lambda rows: als[0]._program_fn(
                rev)())
        # on the CPU a program is sized to its hits
        plain = _program_snapshots(als[1], seeded[1], als[1]._program)
        assert len(graphed) == len(eager) == len(plain) == programs
        for (a, ra), (b, rb), (c, rc) in zip(graphed, eager, plain):
            assert a == b == c
            assert torch.equal(ra, rb) and torch.equal(ra, rc)
        assert graphed[-1][0] > 0
        # the pack: its graph's replay, the function on the card, the CPU
        packs = [als[0]._pack(),
                 pack_candidates(als[0]._buf, als[0]._kept_rows),
                 als[1]._pack()]
        kept = [int(c[0]) for _, c in packs]
        assert kept[0] == kept[1] == kept[2] > 0
        for out, counts in packs:
            assert torch.equal(counts.cpu(), packs[2][1])
            assert torch.equal(out[:kept[0]].cpu(), packs[2][0][:kept[0]])
        return
    pytest.fail("no chunk-strand with full programs and a partial last one")


def test_programs_and_pack_make_no_host_sync_on_the_card(dev):
    """A chunk-strand's programs (graph replays) and its pack under
    torch.cuda.set_sync_debug_mode("error") raise nothing, the first
    capture inside the window too; the finisher's fetch then gives the
    CPU's HSPs."""
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    ref, query, qrc, kw, work = _small_pair_work()
    als = [DeviceAligner(**{**kw, "device": d}) for d in (dev, "cpu")]
    for al in als:
        al.set_ref(ref)
        al.set_query(query, qrc)
    n = 0
    for w in work[:6]:
        want = als[1].seed_and_filter(w.chunk_start, w.chunk_end, w.rev)
        s = als[0]._seed_chunk(w.chunk_start, w.chunk_end, w.rev,
                               into=als[0]._buffers())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            p = als[0]._extend_seeded(s)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = als[0].finish_chunk(p)
        np.testing.assert_array_equal(got.hsps, want.hsps)
        n += len(want.hsps)
    assert n > 0 and set(als[0]._graphs) == {False, True, "pack"}


def test_two_aligners_capture_and_replay_on_two_threads(dev):
    """Two aligners on one card, each on a thread of its own, started
    together: both capture their graphs (a program's of each strand, and
    the pack's) at once and replay them, and each gives one aligner's
    arrays, launching one K1s and one K4s a program."""
    import threading
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    ref, query, qrc, kw, work = _small_pair_work()
    one = DeviceAligner(**kw)
    pair = [DeviceAligner(**kw) for _ in range(2)]
    for al in (one, *pair):
        al.set_ref(ref)
        al.set_query(query, qrc)
    want = one.map_chunks(work)
    start = threading.Barrier(2)
    got, errors = [None, None], []

    def run(i):
        try:
            torch.cuda.set_device(0)
            start.wait()
            got[i] = pair[i].map_chunks(work)
        except Exception as e:   # raised below, in the test's thread
            errors.append(e)

    since = launch_counts()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    programs = sum(-(-r.num_hits // pair[0].HBUF) for r in want)
    _assert_engine_launched(since, ranges=2 * programs)
    for g in got:
        _assert_same_results(g, want)
    assert all(set(al._graphs) == {False, True, "pack"} for al in pair)


def test_a_buffer_of_one_row_extends_again_on_the_card(dev):
    """A candidate buffer of one row on the card: the finisher extends
    each chunk-strand that passes it again, into a grown buffer with its
    graphs captured anew (in a memory pool of their own: the old graphs'
    pool takes no capture once they have gone), and every chunk-strand's
    HSPs equal the CPU's; the launches count each program's two
    replays."""
    from segalign_tpu_torch.pipeline.device import DeviceAligner
    ref, query, qrc, kw, work = _small_pair_work()
    als = [DeviceAligner(**{**kw, "device": d}) for d in (dev, "cpu")]
    for al in als:
        al.set_ref(ref)
        al.set_query(query, qrc)
    als[0]._cand_rows = 1
    since = launch_counts()
    got = als[0].map_chunks(work)
    want = als[1].map_chunks(work)
    _assert_same_results(got, want)
    again = [r.reextended for r in got]
    assert again[0] == 1 and sum(again) >= 1
    programs = sum(-(-r.num_hits // als[0].HBUF) * (1 + r.reextended)
                   for r in got)
    _assert_engine_launched(since, ranges=programs)
