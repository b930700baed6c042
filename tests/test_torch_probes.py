"""The launch-cost probe's kernel (S3, S4) against a Pallas call in
interpret mode, and the port's measurement scripts refusing to run without
a CUDA device.

The JAX probes' kernel bodies are closures inside probe_env.probe_pallas
and probe_extension.probe_overhead and cannot be imported, so the Pallas
call below restates their one-line body, `o_ref[:] = x_ref[:] * 2`, with
their block specs."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from segalign_tpu_torch.ops.probe import scale2_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_scale2(x):
    def kern(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2
    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(x)


@pytest.mark.parametrize("shape", [(256, 512), (8, 128)])
def test_scale2_plain_matches_interpreted_kernel(shape):
    """(256, 512) is S3's shape (probe_env), (8, 128) S4's
    (probe_extension); exact, both are one float multiply by 2."""
    rng = np.random.default_rng(shape[0])
    x = (rng.standard_normal(shape) * 1e3).astype(np.float32)
    x.flat[:4] = [0.0, -0.0, np.finfo(np.float32).max / 4, 1e-30]
    want = np.asarray(_pallas_scale2(jnp.asarray(x)))
    got = scale2_plain(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("script,argv", [
    ("exp_gather_variants", ["2"]),
    ("probe_env", ["dispatch", "pallas"]),
    ("probe_extension", ["gather", "overhead"]),
])
def test_script_fails_without_cuda(script, argv):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", f"segalign_tpu_torch.scripts.{script}",
         *argv], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert r.stdout == ""
