"""The gather experiment's plain versions (S1 in three modes, S2) against
the JAX experiment's Pallas kernels in interpret mode, with zero tolerance.

scripts/exp_gather_variants.py is loaded as a private module instance; its
B, W, BR and AW globals are set small on that instance, and its `pl` is a
copy of jax.experimental.pallas whose pallas_call runs in interpret mode,
so _mk and _mk4 build their own grid specs unchanged. The file itself is
not changed. The interpreter gives v2 (extraction from scratch that is
never written) zeros."""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from segalign_tpu_torch.ops.gather_variants import (
    awin_for, gather_dbuf, gather_dbuf_plain, gather_dma_only,
    gather_dma_only_plain, gather_extract_only, gather_extract_only_plain,
    gather_two_sided, gather_two_sided_plain)
from segalign_tpu_torch.ops.probe import scale2, scale2_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, BR = 64, 16


def _experiment(W):
    spec = importlib.util.spec_from_file_location(
        f"_exp_gather_variants_{W}",
        os.path.join(ROOT, "scripts", "exp_gather_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    mod.pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.B, mod.W, mod.BR, mod.AW = B, W, BR, awin_for(W)
    return mod


def _inputs(rng, W, extra=0):
    """A sequence of 5000 + extra + AW codes (walls and pads included) and
    B starts in [0, len - AW]: both ends, on and just off 1024
    boundaries, the rest random."""
    AW = awin_for(W)
    seq = rng.integers(0, 8, 5000 + extra + AW).astype(np.uint8)
    hi = len(seq) - AW
    starts = rng.integers(0, hi + 1, B).astype(np.int32)
    starts[:10] = [0, hi, 1024, 1023, 1025, 2048, 2047, 4096, 4095, hi - 1]
    return seq, starts


@pytest.mark.parametrize("W", [128, 512])
@pytest.mark.parametrize("mode", ["v1", "v2", "v3"])
def test_s1_plain_matches_interpreted_kernel(mode, W):
    mod = _experiment(W)
    kernel, banks, plain = dict(
        v1=(mod._v1_kernel, 1, gather_dma_only_plain),
        v2=(mod._v2_kernel, 1, gather_extract_only_plain),
        v3=(mod._v3_kernel, 2, gather_dbuf_plain))[mode]
    seq, starts = _inputs(np.random.default_rng(W + len(mode)), W)
    want = np.asarray(mod._mk(kernel, banks)(jnp.asarray(starts),
                                             jnp.asarray(seq)))
    got = plain(torch.from_numpy(seq), torch.from_numpy(starts), W)
    assert got.dtype == torch.uint8 and got.shape == (B, W)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    if mode == "v2":
        assert not want.any()


@pytest.mark.parametrize("W", [128, 512])
def test_s2_plain_matches_interpreted_kernel(W):
    """Both sides in one launch, from sequences of different lengths."""
    mod = _experiment(W)
    rng = np.random.default_rng(40 + W)
    seq_r, st_r = _inputs(rng, W)
    seq_q, st_q = _inputs(rng, W, extra=3001)
    starts2 = np.concatenate([st_r, st_q])
    want_r, want_q = mod._mk4()(jnp.asarray(starts2), jnp.asarray(seq_r),
                                jnp.asarray(seq_q))
    r, q = gather_two_sided_plain(torch.from_numpy(seq_r),
                                  torch.from_numpy(seq_q),
                                  torch.from_numpy(starts2), W)
    np.testing.assert_array_equal(r.numpy().astype(np.int32),
                                  np.asarray(want_r))
    np.testing.assert_array_equal(q.numpy().astype(np.int32),
                                  np.asarray(want_q))


def test_wrappers_on_cpu_take_plain_versions():
    """On CPU tensors every wrapper returns its plain version's value and
    counts no launch."""
    rng = np.random.default_rng(3)
    W = 512
    seq, starts = (torch.from_numpy(a) for a in _inputs(rng, W))
    seq_q, st_q = (torch.from_numpy(a) for a in _inputs(rng, W, extra=77))
    starts2 = torch.cat([starts, st_q])
    x = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    wrappers = (gather_dma_only, gather_extract_only, gather_dbuf,
                gather_two_sided, scale2)
    before = [w.launches for w in wrappers]
    for fn, plain in ((gather_dma_only, gather_dma_only_plain),
                      (gather_extract_only, gather_extract_only_plain),
                      (gather_dbuf, gather_dbuf_plain)):
        assert torch.equal(fn(seq, starts, W), plain(seq, starts, W))
    for a, b in zip(gather_two_sided(seq, seq_q, starts2, W),
                    gather_two_sided_plain(seq, seq_q, starts2, W)):
        assert torch.equal(a, b)
    assert torch.equal(scale2(x), scale2_plain(x))
    assert [w.launches for w in wrappers] == before


def test_wrappers_reject_bad_arguments():
    seq = torch.zeros(10_000, dtype=torch.uint8)
    starts = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        gather_dbuf(seq, starts, 100)
    with pytest.raises(ValueError, match="multiple of 16"):
        gather_dma_only(seq, starts, 4096)
    with pytest.raises(ValueError, match="int32"):
        gather_extract_only(seq, starts.long(), 512)
    with pytest.raises(ValueError, match="uint8"):
        gather_dbuf(seq.int(), starts, 512)
    with pytest.raises(ValueError, match="superset"):
        gather_dbuf(seq[:2000], starts, 512)
    with pytest.raises(ValueError, match="divisible by 2"):
        gather_two_sided(seq, seq, starts[:7], 512)
    with pytest.raises(ValueError, match="float32"):
        scale2(torch.ones(4, dtype=torch.float64))
