"""The decomposition of the warp-per-row scan kernels (csrc/scan.cuh) is
exact: a numpy model of it against extend3.scan_ext_window, zero tolerance.

The kernel cuts the window's dependent chain (running sum, running max,
first drop, best before it) into groups of 16 lanes, one a thread, joined
across the threads of a warp: a wrapping prefix sum of the groups' sums, a
prefix max of the groups' true values, the first group that drops and the
best (value, earliest lane) of the groups up to it; a chunk of THREADS x 16
lanes a step, the carried values going from chunk to chunk; after the drop
only the sum runs on; the match counts split at the final max position.
blocked_scan below does exactly that in numpy int32 (which wraps as the
kernel's int32 does), for any number of threads, so small windows cover
several chunks. Nothing on the port's paths calls it.

Covered: both directions, counts on and off, the in-bounds length at 0, 1,
15, 16, 17, 511, 512, 513, W - 1 and W, carried states already past the
drop, rows done on entry, ties (a table of small scores) and sums that
wrap (a table of scores near 2^30 and carried sums near 2^31)."""

import numpy as np
import pytest
import torch

from segalign_tpu_torch.config import build_substitution_matrix
from segalign_tpu_torch.ops.extend3 import (NEG, STATE_KEYS,
                                            scan_ext_window,
                                            state_from_numpy,
                                            state_to_numpy)

GROUP = 16
I32 = np.int32
BIG = np.iinfo(np.int32).max


def blocked_scan(r, q, loc_r, loc_q, st, sub, xdrop, tile, ref_len,
                 query_len, *, W, left, with_counts, threads=32):
    """The kernel's decomposition on (B, W) windows in extension order.
    All sums are numpy int32 array operations, which wrap."""
    B = r.shape[0]
    chunk = threads * GROUP
    xdrop = I32(xdrop)
    if left:
        p0 = tile + 1
        lim = np.minimum(loc_r, loc_q).astype(np.int64) + 1
    else:
        p0 = tile
        lim = np.minimum(ref_len - loc_r.astype(np.int64),
                         query_len - loc_q.astype(np.int64))
    n_inb64 = lim - p0
    n_inb = np.clip(n_inb64, 0, W).astype(np.int64)
    kend = np.maximum(n_inb, 1)
    nchunks = (W + chunk - 1) // chunk
    # pad the window to whole chunks with zeros, as load_block does
    Wp = nchunks * chunk
    rp = np.zeros((B, Wp), np.int64)
    qp = np.zeros((B, Wp), np.int64)
    rp[:, :W], qp[:, :W] = r, q
    k_all = np.arange(Wp)

    c = st["cum"].astype(I32).copy()
    m = st["maxv"].astype(I32).copy()
    best = np.full(B, NEG, I32)
    bestk = np.full(B, -1, np.int64)
    dk = np.full(B, W, np.int64)
    tail = np.zeros(B, I32)
    rows = np.arange(B)
    for ci in range(nchunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        k = k_all[sl].reshape(threads, GROUP)[None]
        idx = ((rp[:, sl] & 7) * 8 + (qp[:, sl] & 7))
        s = np.where(k_all[sl][None] < n_inb[:, None], sub[idx], 0).astype(
            I32).reshape(B, threads, GROUP)
        # rows whose last tested lane lies before this chunk read nothing
        # more: their scores here are all 0 and they stay as they are
        live = (ci * chunk < kend)
        # pass 1
        t = s.sum(axis=2, dtype=I32)
        past = dk != W
        tail = np.where(past & live, tail + t.sum(axis=1, dtype=I32), tail)
        incl = np.cumsum(t, axis=1, dtype=I32)
        c_lane = c[:, None] + (incl - t)
        # pass 2
        vals = c_lane[:, :, None] + np.cumsum(s, axis=2, dtype=I32)
        imax = np.maximum.accumulate(vals.max(axis=2), axis=1)
        before = np.concatenate([m[:, None], np.maximum(
            m[:, None], imax[:, :-1])], axis=1)
        # pass 3
        mm = np.maximum(before[:, :, None],
                        np.maximum.accumulate(vals, axis=2))
        act = k < kend[:, None, None]
        drop = act & ((mm - vals) > xdrop)
        jd = np.where(drop, np.arange(GROUP)[None, None], GROUP).min(axis=2)
        counted = act & (np.arange(GROUP)[None, None] < jd[:, :, None])
        cand = np.where(counted & (vals > I32(NEG)), vals, I32(NEG))
        lbest = cand.max(axis=2)
        lbestk = np.where(counted & (cand == lbest[:, :, None])
                          & (vals > I32(NEG)), k, BIG).min(axis=2)
        dropped = jd < GROUP
        anyd = dropped.any(axis=1)
        first = np.where(anyd, dropped.argmax(axis=1), threads)
        upto = np.arange(threads)[None] <= first[:, None]
        lbest = np.where(upto, lbest, I32(NEG))
        lbestk = np.where(upto, lbestk, BIG)
        cb = lbest.max(axis=1)
        ck = np.where(lbest == cb[:, None], lbestk, BIG).min(axis=1)
        run = ~past & live
        new_dk = ci * chunk + first * GROUP + jd[rows, np.minimum(
            first, threads - 1)]
        dk = np.where(run & anyd, new_dk, dk)
        better = run & (cb > best)
        best = np.where(better, cb, best)
        bestk = np.where(better, ck, bestk)
        c = np.where(run, c + incl[:, -1], c)
        m = np.where(run, np.maximum(m, imax[:, -1]), m)
    c = c + tail

    Mv = np.maximum(best, st["maxv"])
    is_new = Mv > st["maxv"]
    Mp = np.where(is_new, p0 + bestk, st["maxp"]).astype(I32)
    finish = (dk < W) | (n_inb64 < W)
    counts, cdel = st["counts"].astype(I32), st["cdel"].astype(I32)
    if with_counts:
        kin = Mp.astype(np.int64) - p0
        kk = np.arange(W)[None]
        match = (kk < n_inb[:, None]) & (r == q) & (r < 4)
        inside = kk <= kin[:, None]
        onehot = r[:, :, None] == np.arange(4)[None, None]
        ain = ((match & inside)[:, :, None] & onehot).sum(axis=1).astype(I32)
        aout = ((match & ~inside)[:, :, None] & onehot).sum(
            axis=1).astype(I32)
        new_max = (Mp > st["maxp"])[:, None]
        counts, cdel = (np.where(new_max, counts + cdel, counts) + ain,
                        np.where(new_max, 0, cdel).astype(I32) + aout)
    alive = ~st["done"]
    out = dict(done=st["done"] | finish, cum=c, maxv=Mv, maxp=Mp,
               counts=counts, cdel=cdel)
    return {key: np.where(alive.reshape((B,) + (1,) * (out[key].ndim - 1)),
                          out[key], st[key]) for key in STATE_KEYS}


def _table(kind, rng):
    if kind == "default":
        return build_substitution_matrix(910).reshape(-1).astype(I32)
    if kind == "ties":
        return rng.integers(-2, 3, 64).astype(I32)
    return rng.integers(-2**30, 2**30, 64).astype(I32)   # "wrap"


def _case(kind, rng, W, left, tile):
    """Windows in extension order with a shared core (long extensions),
    walls, masked runs, and anchors that put the in-bounds length at every
    edge; carried states of which some are done and some already past the
    drop."""
    edges = [0, 1, 15, 16, 17, 511, 512, 513, W - 1, W, W + 5]
    B = 96
    n = 20000
    r = rng.integers(0, 4, (B, W)).astype(np.uint8)
    q = r.copy()
    mut = rng.random((B, W)) < rng.uniform(0.0, 0.5, (B, 1))
    q[mut] = rng.integers(0, 8, int(mut.sum()))
    r[60:][rng.random((B - 60, W)) < 0.01] = 7
    q[30:40] = r[30:40]      # clean rows: they run through the window
    r[5:9, 30:40] = 4
    q[7:12, 20:28] = 5
    loc_r = rng.integers(3 * W, n - 3 * W, B).astype(I32)
    loc_q = rng.integers(3 * W, n - 3 * W, B).astype(I32)
    for i, e in enumerate(edges):
        # in-bounds length e on row i, through the ref or the query
        if left:
            (loc_r if i % 2 else loc_q)[i] = tile + e
        else:
            (loc_r if i % 2 else loc_q)[i] = n - tile - e
    if kind == "wrap":
        cum = rng.integers(-2**31, 2**31, B).astype(I32)
        maxv = rng.integers(-2**31, 2**31, B).astype(I32)
    else:
        cum = rng.integers(-300, 4000, B).astype(I32)
        maxv = (cum + rng.integers(0, 800, B)).astype(I32)
        # already more than xdrop under the max on entry
        maxv[20:26] = cum[20:26] + 915
        maxv[:3] = cum[:3] + 2000
    st = dict(done=rng.random(B) < 0.25, cum=cum, maxv=maxv,
              maxp=rng.integers(0, tile + 1, B).astype(I32),
              counts=rng.integers(0, 40, (B, 4)).astype(I32),
              cdel=rng.integers(0, 40, (B, 4)).astype(I32))
    st["done"][:len(edges)] = False
    st["done"][20:40] = False
    return r, q, loc_r, loc_q, st, n


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("W,threads,tile", [
    (512, 32, 0), (2048, 32, 2048), (48, 32, 96), (592, 32, 0),
    (640, 4, 1280), (2048, 8, 512)])
@pytest.mark.parametrize("kind", ["default", "ties", "wrap"])
def test_blocked_scan_equals_plain(kind, W, threads, tile, left,
                                   with_counts):
    seed = sum(map(ord, kind)) + 7 * W + threads + 3 * left + with_counts
    rng = np.random.default_rng(seed)
    sub = _table(kind, rng)
    r, q, loc_r, loc_q, st, n = _case(kind, rng, W, left, tile)
    xdrop = 910 if kind != "ties" else 3
    got = blocked_scan(r, q, loc_r, loc_q, st, sub, xdrop, tile, n, n,
                       W=W, left=left, with_counts=with_counts,
                       threads=threads)
    want = state_to_numpy(scan_ext_window(
        torch.from_numpy(r), torch.from_numpy(q), torch.from_numpy(loc_r),
        torch.from_numpy(loc_q), state_from_numpy(st),
        torch.from_numpy(sub), xdrop, tile, n, n, W=W, left=left,
        with_counts=with_counts))
    for key in STATE_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the case is not trivial: rows that drop, rows that run on, new maxima
    alive = ~st["done"]
    assert (want["done"] & alive).any()
    if kind == "default":
        assert (~want["done"]).any()
        assert (want["maxv"] > st["maxv"]).any()
