"""A cell of the benchmark on the CPU: the port's bench.run_config against
the root bench.py's (the JAX package's) on the same pair, equal in seeds,
hits, HSPs and every chunk-strand's HSP array (each saves them through
BENCH_SAVE_HSPS).

One file a cell, so that the test workers spread them (each costs the
JAX side's compilation): this one holds repeat-1x, the others the 4x
density sweep and legacy-planted, through check_cell."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the JAX package's benchmark)
from segalign_tpu_torch import bench as port_bench  # noqa: E402
from segalign_tpu_torch import bench_inputs  # noqa: E402

# each family's sizes (ref Mbp, query Mbp) here; the sweep's genomes are
# both min(ref Mbp, 2) long
SIZES = {"repeat-1x": (0.3, 0.2), "repeat-4x": (0.2, 0.2),
         "legacy-planted": (0.3, 0.2)}


def check_cell(name, tmp_path, monkeypatch):
    ref, query = bench_inputs.make_inputs(name, *SIZES[name])
    out = {}
    for side, run in (("jax", lambda: bench.run_config(ref, query, name)),
                      ("port", lambda: port_bench.run_config(
                          ref, query, name, "cpu"))):
        path = str(tmp_path / f"{side}.npz")
        monkeypatch.setenv("BENCH_SAVE_HSPS", path)
        res = run()
        with np.load(path) as z:
            out[side] = (res["stats"], {k: z[k] for k in z.files})
    (want, want_h), (got, got_h) = out["jax"], out["port"]
    assert got == want
    assert want["hsps"] > 0
    assert got_h.keys() == want_h.keys()
    for k in want_h:
        assert got_h[k].dtype == np.int64
        np.testing.assert_array_equal(got_h[k], want_h[k], err_msg=k)


@pytest.mark.parametrize("name", ["repeat-1x"])
def test_run_config_matches_jax(name, tmp_path, monkeypatch):
    check_cell(name, tmp_path, monkeypatch)
