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
    ("path_walls", ["tree"]),
    ("program_walls", ["tree"]),
    ("k1s_rows", ["tree"]),
    ("k4s_rows", ["tree"]),
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


def test_program_walls_summarizes_a_cells_runs(tmp_path):
    """program_walls --summarize on saved cell outputs, P C C P C: each
    label's values in run order, median, quartiles, largest three-run
    move, peaks, and the pairs of runs next to each other each won."""
    import json
    from segalign_tpu_torch.scripts.program_walls import summarize
    paths = []
    for i, (lab, v, peak) in enumerate([("P", 10.0, 0.2), ("C", 15.0, 0.17),
                                        ("C", 18.0, 0.17), ("P", 12.0, 0.2),
                                        ("P", 11.0, 0.2), ("C", 16.0, 0.17)],
                                       1):
        p = tmp_path / f"cell-a_{lab}_{i}.txt"
        p.write_text("some output\n" + json.dumps(dict(
            query_mbp_per_s=v, peak_device_gib=peak, correct=True)) + "\n")
        paths.append(str(p))
    got = summarize(paths)["cell-a"]
    assert got["P"]["values"] == [10.0, 12.0, 11.0]
    assert got["C"]["values"] == [15.0, 18.0, 16.0]
    assert got["P"]["median"] == 11.0 and got["C"]["median"] == 16.0
    assert got["P"]["largest_3run_move"] == round(2 / 11, 4)
    assert got["C"]["peaks_gib"] == [0.17] and got["C"]["correct"]
    assert got["pairs_won"] == {"C": 3, "P": 0}
