"""The port's whole-batch extension against the JAX program.

segalign_tpu_torch.ops.extend_fused.extend_fields_program must return the
same fields (candidate, rs, qs, length, total, counts) as
segalign_tpu.ops.extend_fused.extend_fields_program(engine="xla") for the
same rows, for every first-window and continuation width: the scan's
results do not depend on how the extension is cut into windows."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from segalign_tpu.config import build_substitution_matrix
from segalign_tpu.ops import extend_fused as jf
from segalign_tpu.ops.extend import pad_sequence
from segalign_tpu_torch.ops.extend_fused import extend_fields_program

FIELDS = ("candidate", "rs", "qs", "length", "total", "counts")
SUB = build_substitution_matrix(910).reshape(-1).astype(np.int32)


def _batch(seed, n, core_len, B):
    """A pair whose shared core makes extensions many windows long, plus
    random hits, hits at both ends and at a wall."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = rng.integers(0, 4, core_len).astype(np.uint8)
    ref[2000:2000 + core_len] = core
    query[7000:7000 + core_len] = core
    ref[n - 900] = 7
    rl = rng.integers(0, n, B).astype(np.int32)
    ql = rng.integers(0, n, B).astype(np.int32)
    d = B // 2
    off = rng.integers(50, core_len - 100, d).astype(np.int32)
    rl[:d] = 2000 + off
    ql[:d] = 7000 + off
    rl[d:d + 6] = [0, 1, n - 1, n - 30, n - 905, 17]
    ql[d:d + 6] = [3, 0, n - 3, n - 31, n - 950, 29]
    return ref, query, rl, ql


def _port(ref, query, rl, ql, m, pad, W, W_CONT, with_counts, hsp=1800):
    n = len(ref)
    out = extend_fields_program(
        torch.from_numpy(pad_sequence(ref, pad)),
        torch.from_numpy(pad_sequence(query, pad)), torch.from_numpy(rl),
        torch.from_numpy(ql), m, torch.from_numpy(SUB), 910, hsp, n, n,
        pad=pad, W=W, W_CONT=W_CONT, with_counts=with_counts)
    return {k: out[k].numpy() for k in FIELDS}


@pytest.mark.parametrize("with_counts", [False, True])
def test_extend_fields_program_matches_jax_xla(with_counts):
    ref, query, rl, ql = _batch(44, 10_000, 3000, 256)
    n, pad, m = len(ref), 2048, 250
    want = jf.extend_fields_program(
        jnp.asarray(pad_sequence(ref, pad)),
        jnp.asarray(pad_sequence(query, pad)), jnp.asarray(rl),
        jnp.asarray(ql), m, jnp.asarray(SUB), 910, 1800, n, n, pad=pad,
        W=256, CONT=128, engine="xla", W_CONT=1024, UNROLL=2,
        with_counts=with_counts)
    want = {k: np.asarray(want[k]) for k in FIELDS}
    assert want["candidate"].sum() > 10
    # W = 512 and W = 256 first windows give the same fields
    for W, W_CONT in ((512, 2048), (256, 1024)):
        got = _port(ref, query, rl, ql, m, pad, W, W_CONT, with_counts)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"W={W} {k}")


def _copies(seed, n, B):
    """A pair in which the query repeats two long stretches of the
    reference with a few substitutions: one at 1500 (the query's at 1509),
    one at the reference's start that ends the query. Half the hits lie on
    the copies, so their extensions run through several W_CONT windows
    and into the query's end or the reference's start; the rest are
    random, a few within a window of the sequences' ends."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n).astype(np.uint8)
    query = rng.integers(0, 4, n).astype(np.uint8)
    core = 4200
    query[1509:1509 + core] = ref[1500:1500 + core]
    query[n - core:] = ref[:core]
    sites = rng.integers(0, n, 40)
    query[sites] = (query[sites] + 1) % 4
    rl = rng.integers(0, n, B).astype(np.int32)
    ql = rng.integers(0, n, B).astype(np.int32)
    t = rng.integers(0, core, B // 2)
    d = B // 4
    rl[:d], ql[:d] = 1500 + t[:d], 1509 + t[:d]
    rl[d:2 * d], ql[d:2 * d] = t[d:], n - core + t[d:]
    rl[2 * d:2 * d + 6] = [0, 1, n - 1, n - 30, n - 900, 17]
    ql[2 * d:2 * d + 6] = [n - 3, 5, 0, n - 31, 2, n - 1]
    return ref, query, rl, ql


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("seed", [47, 48])
def test_window_scan_seq_through_extend_fields_program(seed, with_counts):
    """The continuation (window_scan_seq, its plain version on the CPU)
    through extend_fields_program against the JAX program on rows that
    stay alive across several W_CONT windows and rows that run into either
    end of either sequence, counts off and on; the JAX program's shapes
    are the test above's, so its compile is reused."""
    ref, query, rl, ql = _copies(seed, 10_000, 256)
    n, pad, m = len(ref), 2048, 250
    want = jf.extend_fields_program(
        jnp.asarray(pad_sequence(ref, pad)),
        jnp.asarray(pad_sequence(query, pad)), jnp.asarray(rl),
        jnp.asarray(ql), m, jnp.asarray(SUB), 910, 1800, n, n, pad=pad,
        W=256, CONT=128, engine="xla", W_CONT=1024, UNROLL=2,
        with_counts=with_counts)
    want = {k: np.asarray(want[k]) for k in FIELDS}
    got = _port(ref, query, rl, ql, m, pad, 256, 1024, with_counts)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # extensions three W_CONT windows long and more, and ones that end at
    # a sequence's end on either side
    assert (want["length"] > 256 + 3 * 1024).sum() > 20
    at_left = (want["rs"] == 0) & want["candidate"]
    at_right = (want["qs"] + want["length"] == n - 1) & want["candidate"]
    assert at_left.any() and at_right.any()


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_survivor_steps_cut_into_parts_change_no_field(rows, monkeypatch):
    """A survivor step of more alive rows than SURVIVOR_ROWS runs as several
    parts: every field equals the one-part run's (which the test above
    holds to the JAX program)."""
    from segalign_tpu_torch.ops import extend_fused
    ref, query, rl, ql = _batch(44, 10_000, 3000, 256)
    want = _port(ref, query, rl, ql, 250, 2048, 256, 1024, True)
    monkeypatch.setattr(extend_fused, "SURVIVOR_ROWS", rows)
    got = _port(ref, query, rl, ql, 250, 2048, 256, 1024, True)
    assert want["candidate"].sum() > 10
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mixed_continuation_width_is_exact():
    """Port of tests/test_pallas_kernel.py::test_mixed_continuation_
    width_is_exact: continuation widths other than the first window's
    give the same fields, equal to the JAX program's."""
    ref, query, rl, ql = _batch(45, 16_000, 6000, 512)
    n, pad = len(ref), 1024
    base = jf.extend_program(
        jnp.asarray(pad_sequence(ref, pad)),
        jnp.asarray(pad_sequence(query, pad)), jnp.asarray(rl),
        jnp.asarray(ql), jnp.ones(len(rl), bool), jnp.asarray(SUB), 910,
        1800, n, n, pad=pad, W=128, CONT=128, W_CONT=0, UNROLL=1)
    base = {k: np.asarray(base[k]) for k in FIELDS}
    assert base["candidate"].sum() > 0
    for W_CONT in (128, 512, 1024):
        got = _port(ref, query, rl, ql, len(rl), pad, 128, W_CONT, True)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], base[k],
                                          err_msg=f"W_CONT={W_CONT} {k}")


def test_pad_must_cover_windows():
    ref, query, rl, ql = _batch(46, 8000, 1000, 16)
    with pytest.raises(ValueError, match="pad"):
        _port(ref, query, rl, ql, 16, 512, 512, 2048, False)
