"""K5's plain version (window_scan_wide on CPU tensors) against the Pallas
kernel it replaces, window_scan_pallas, run in interpret mode as the JAX
tests run it on the CPU.

The TPU kernel's sums are exact int32 roll scans, so the two must agree
bit for bit with walls (code 7) in the windows, beside soft-masked (4) and
N (5) runs and rows at both sequence ends: at tile 0 from a fresh state
(the route's first window) and at tile > 0 from carried states with half
the rows alive. Shapes stay small (B = W = 256) for the interpreter."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segalign_tpu.config import build_substitution_matrix
from segalign_tpu.ops.extend_pallas import window_scan_pallas
from segalign_tpu_torch.ops.extend3 import (STATE_KEYS, init_state,
                                            state_from_numpy,
                                            state_to_numpy)
from segalign_tpu_torch.ops.gather import gather_rows_plain
from segalign_tpu_torch.ops.padding import pad_sequence
from segalign_tpu_torch.ops.window_scan_wide import (window_scan_wide,
                                                     window_scan_wide_plain)

SUB = build_substitution_matrix(910).reshape(-1).astype(np.int32)
T = torch.from_numpy
N, W, B, PAD = 4000, 256, 256, 1024


def _case(rng):
    """A pair with a shared core, walls inside it, soft-masked and N runs,
    and anchors on the core, at both sequence ends and beside the walls."""
    ref = rng.integers(0, 4, N).astype(np.uint8)
    query = rng.integers(0, 4, N).astype(np.uint8)
    core = rng.integers(0, 4, 1500).astype(np.uint8)
    ref[800:2300] = core
    query[1500:3000] = core
    ref[[1400, 3500]] = 7
    query[[2100, 2550]] = 7
    ref[200:230] = 4
    query[400:420] = 5
    ref[2000:2010] = 5
    rl = rng.integers(0, N, B).astype(np.int32)
    ql = rng.integers(0, N, B).astype(np.int32)
    d = B // 3
    off = rng.integers(20, 1480, d).astype(np.int32)
    rl[:d] = 800 + off
    ql[:d] = 1500 + off
    rl[d:d + 10] = [0, 1, 5, N - 1, N - 2, N - 40, 1395, 1410, 3490, 2005]
    ql[d:d + 10] = [3, 0, N - 1, N - 3, 7, N - 41, 2095, 2110, 2545, 2705]
    return pad_sequence(ref, PAD), pad_sequence(query, PAD), rl, ql


def _windows(rp, qp, rl, ql, tile, left):
    """The route's windows: a raw gather, flipped into extension order to
    the left."""
    off = -tile - W if left else tile
    r = gather_rows_plain(T(rp), T(PAD + rl + off), W)
    q = gather_rows_plain(T(qp), T(PAD + ql + off), W)
    return (r.flip(1), q.flip(1)) if left else (r, q)


def _carried(rng, tile):
    """Half the rows alive on entry; maxv at or above cum, maxp before the
    window, nonzero pending counts."""
    cum = rng.integers(-300, 4000, B).astype(np.int32)
    return dict(done=rng.random(B) < 0.5, cum=cum,
                maxv=(cum + rng.integers(0, 800, B)).astype(np.int32),
                maxp=rng.integers(0, tile + 1, B).astype(np.int32),
                counts=rng.integers(0, 40, (B, 4)).astype(np.int32),
                cdel=rng.integers(0, 40, (B, 4)).astype(np.int32))


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("tile", [0, 3 * W])
@pytest.mark.parametrize("left", [False, True])
def test_window_scan_wide_plain_matches_pallas(left, tile, with_counts):
    rng = np.random.default_rng(100 + 4 * left + 2 * bool(tile) + with_counts)
    rp, qp, rl, ql = _case(rng)
    r, q = _windows(rp, qp, rl, ql, tile, left)
    if tile == 0:
        valid = rng.random(B) > 0.1
        st = state_to_numpy(init_state(B, 0 if left else -1, T(valid),
                                       "cpu"))
    else:
        st = _carried(rng, tile)
    want = window_scan_pallas(
        jnp.asarray(r.numpy().astype(np.int32)),
        jnp.asarray(q.numpy().astype(np.int32)), jnp.asarray(rl),
        jnp.asarray(ql), jnp.asarray(st["cum"]), jnp.asarray(st["maxv"]),
        jnp.asarray(st["maxp"]), jnp.asarray(st["done"]),
        jnp.asarray(st["counts"]), jnp.asarray(st["cdel"]),
        jnp.asarray(SUB), 910, tile, N, N, W=W, left=left, BR=128,
        interpret=True, with_counts=with_counts)
    before = window_scan_wide.launches
    got = state_to_numpy(window_scan_wide(
        r, q, T(rl), T(ql), state_from_numpy(st), T(SUB), 910, tile, N, N,
        W=W, left=left, with_counts=with_counts))
    assert window_scan_wide.launches == before  # CPU tensors: plain version
    for k, w in zip(STATE_KEYS, want):
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
    # the window finished some alive rows, left others alive, and moved
    # some maxima
    alive = ~st["done"]
    assert (got["done"] & alive).sum() > 0 and (~got["done"]).sum() > 0
    assert (got["maxp"] != st["maxp"]).sum() > 0
    if with_counts:
        assert (got["counts"] != st["counts"]).sum() > 0


def test_plain_is_the_raw_scan_of_flipped_windows():
    """window_scan_wide_plain on flipped left windows is K4's plain version
    on the raw ones: the two scans share one body."""
    from segalign_tpu_torch.ops.window_scan import window_scan_plain
    rng = np.random.default_rng(9)
    rp, qp, rl, ql = _case(rng)
    tile = 2 * W
    st = state_from_numpy(_carried(rng, tile))
    raw = [gather_rows_plain(T(s), T(PAD + loc - tile - W), W)
           for s, loc in ((rp, rl), (qp, ql))]
    args = (T(rl), T(ql), st, T(SUB), 910, tile, N, N)
    a = window_scan_plain(*raw, *args, W=W, left=True, with_counts=True)
    b = window_scan_wide_plain(raw[0].flip(1), raw[1].flip(1), *args, W=W,
                               left=True, with_counts=True)
    for k in STATE_KEYS:
        assert torch.equal(a[k], b[k]), k
