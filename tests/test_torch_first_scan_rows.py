"""K1 on the padded sequences (csrc/first_scan.cu first_scan_seq_kernel)
as its threads walk, in numpy (first_scan_rows_model.py), held exactly to
first_scan_seq_plain: the alignment of a row's q bytes at each of the 16
byte offsets, blocks past a sequence's end, the switch of a warp to the
sums at its last row's drop, and the counts snapshot at each new best.
The kernel itself is held to the plain version in test_torch_cuda.py and
chip_smoke.py, and the model to the JAX package in
test_torch_seed_on_card.py. About 5 s."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from first_scan_rows_model import align_block, k1s_model  # noqa: E402

from segalign_tpu_torch.config import build_substitution_matrix  # noqa: E402
from segalign_tpu_torch.ops.extend3 import STATE_KEYS  # noqa: E402
from segalign_tpu_torch.ops.first_scan import first_scan_seq_plain  # noqa: E402

SUB = build_substitution_matrix(910).reshape(-1).astype(np.int32)
WALL = 7   # scores -9100 against every code: a drop wherever it stands


@pytest.mark.parametrize("d", range(16))
def test_align_block_at_every_offset(d):
    """Two word selects and four funnel shifts give bytes [d, d + 16) of
    the 32 bytes lo:hi."""
    rng = np.random.default_rng(d)
    raw = rng.integers(0, 256, (64, 32)).astype(np.uint8)
    words = raw.view("<u4")
    got = align_block(words[:, :4], words[:, 4:], np.full(64, d))
    np.testing.assert_array_equal(got.view(np.uint8), raw[:, d:d + 16])


def _seq(rng, n, pad):
    s = np.full(n + 2 * pad, 6, np.uint8)
    s[pad:pad + n] = rng.integers(0, 4, n)
    return s


def _rows(case, W, rng):
    """(ref, query, loc_r, loc_q, valid, pad, n_r, n_q, xdrop, lanes): the
    case's padded sequences and anchors; lanes, where given, the lane of
    each row's first drop in both directions."""
    lanes = None
    if case == "edges":
        # pad under W (the clamp moves windows), lengths no multiple of 16
        # (blocks read past the end), anchors at every offset within a
        # block and within W of both ends, rows not valid, a repeated core,
        # and anchors near -2^31, where pad + loc - W wraps in int32 to the
        # top of the range (the window clamps to the sequence's end)
        n_r, n_q, pad = 4 * W + 23, 3 * W + 7, 40
        ref, query = _seq(rng, n_r, pad), _seq(rng, n_q, pad)
        query[pad + W:pad + 2 * W] = ref[pad + 2 * W:pad + 3 * W]
        base = np.arange(16)
        edges = np.array([0, 1, 15, 16, 17, W - 1, W, W + 1])
        loc_r = np.concatenate([
            W + base, W + 7 + base, edges, n_r - edges, edges, n_r - edges,
            rng.integers(0, n_r + 1, 60), 2 * W + 100 + base,
            [-2**31, -2**31 + 17, -2**31, W + 5]])
        loc_q = np.concatenate([
            W + 3 + base[::-1], W + base, edges[::-1], n_q - edges,
            n_q - edges, edges, rng.integers(0, n_q + 1, 60),
            W + 100 + base, [W + 3, n_q - 5, -2**31 + 1, -2**31]])
        valid = rng.random(len(loc_r)) > 0.1
        valid[-4:] = True
        return ref, query, loc_r, loc_q, valid, pad, n_r, n_q, 910, lanes
    # one sequence as both reference and query, each anchor the same on
    # both: equal windows, no drop but at a wall
    B = {"ragged": 77, "never_drop": 64, "last_lane": 32, "warp": 32}[case]
    gap = 2 * W + 48
    n = B * gap + 3 * W
    pad = 2048
    seq = _seq(rng, n, pad)
    loc = (W + 16 + gap * np.arange(B) + rng.integers(0, 16, B))
    query = seq.copy()
    if case in ("last_lane", "warp", "ragged"):
        if case == "last_lane":
            lanes = np.full(B, W - 1)
        elif case == "warp":   # 32 rows of one warp, 32 lanes
            lanes = rng.permutation(np.linspace(1, W - 2, 32).astype(int))
        else:
            lanes = rng.integers(0, W, B)
        # right lane k is position loc + k, left lane k is loc - 1 - k
        seq[pad + loc + lanes] = WALL
        seq[pad + loc - 1 - lanes] = WALL
    valid = np.ones(B, bool)
    return seq, query, loc, loc, valid, pad, n, n, 910, lanes


CASES = ["edges", "never_drop", "last_lane", "warp", "ragged"]


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("W", [512, 256])
@pytest.mark.parametrize("case", CASES)
def test_model_equals_plain(case, W, with_counts):
    """Every field of both states, exactly; where the case puts each row's
    first drop at a known lane, the plain version agrees, and the warp
    leaves the full recurrence after the block of its last row's drop."""
    rng = np.random.default_rng([CASES.index(case), W, with_counts])
    ref, query, loc_r, loc_q, valid, pad, n_r, n_q, xdrop, lanes = _rows(
        case, W, rng)
    loc_r, loc_q = loc_r.astype(np.int32), loc_q.astype(np.int32)
    kw = dict(pad=pad, W=W, with_counts=with_counts)
    want = first_scan_seq_plain(
        torch.from_numpy(ref), torch.from_numpy(query),
        torch.from_numpy(loc_r), torch.from_numpy(loc_q),
        torch.from_numpy(valid), torch.from_numpy(SUB), xdrop, n_r, n_q, **kw)
    got, switched = k1s_model(ref, query, loc_r, loc_q, valid, SUB, xdrop,
                              n_r, n_q, **kw)
    for w, g in zip(want, got):
        for k in STATE_KEYS:
            np.testing.assert_array_equal(w[k].numpy(), g[k], err_msg=k)
    if case == "never_drop":
        for w in want:
            assert not w["done"].any()
        # the warps ran the full recurrence to their last block
        assert all((s >= W // 16).all() for s in switched)
    if lanes is not None:
        for w in want:   # the drop ended every row, and not before it
            assert w["done"].all()
            assert (w["maxp"].numpy() >= lanes - 1).all()
    if case == "warp":
        for s in switched:   # blocks of 16 lanes from a position in 0..15
            assert lanes.max() // 16 + 1 <= s[0] <= lanes.max() // 16 + 2


@pytest.mark.parametrize("xdrop", [0, -1])
def test_model_equals_plain_at_small_xdrop(xdrop):
    """xdrop 0, where a row drops at its first lane below the running max,
    and a negative one, where every row drops at its first lane."""
    rng = np.random.default_rng(100 + xdrop)
    W = 256
    ref, query, loc_r, loc_q, valid, pad, n_r, n_q, _, _ = _rows(
        "edges", W, rng)
    loc_r, loc_q = loc_r.astype(np.int32), loc_q.astype(np.int32)
    kw = dict(pad=pad, W=W, with_counts=True)
    want = first_scan_seq_plain(
        torch.from_numpy(ref), torch.from_numpy(query),
        torch.from_numpy(loc_r), torch.from_numpy(loc_q),
        torch.from_numpy(valid), torch.from_numpy(SUB), xdrop, n_r, n_q, **kw)
    got, _ = k1s_model(ref, query, loc_r, loc_q, valid, SUB, xdrop, n_r,
                       n_q, **kw)
    for w, g in zip(want, got):
        for k in STATE_KEYS:
            np.testing.assert_array_equal(w[k].numpy(), g[k], err_msg=k)
