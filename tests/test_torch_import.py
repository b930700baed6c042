"""The port stands alone: it imports with jax, the JAX package and the
root bench script blocked, names none of them in any import (chip_smoke.py
included), and runs its plain versions, never a kernel, on CPU tensors."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import torch

import segalign_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(segalign_tpu_torch.__file__)


def _modules():
    names = ["segalign_tpu_torch"]
    for m in pkgutil.walk_packages([PKG], prefix="segalign_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_with_jax_blocked():
    names = _modules()
    assert "segalign_tpu_torch.cli.run_segalign" in names
    code = ("import sys, importlib\n"
            "for blocked in ('jax', 'segalign_tpu', 'bench'):\n"
            "    sys.modules[blocked] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "for blocked in ('jax', 'segalign_tpu', 'bench'):\n"
            "    assert sys.modules[blocked] is None\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def _imported_top_levels(path):
    """(top-level module, line) of every absolute import in a source."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            yield m.split(".")[0], node.lineno


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    return paths


def test_no_jax_import_in_package():
    for path in _port_sources():
        for top, line in _imported_top_levels(path):
            assert top != "jax", (path, line)


def test_no_import_of_the_jax_package_or_bench():
    paths = _port_sources()
    assert len(paths) > 40
    for path in paths:
        for top, line in _imported_top_levels(path):
            assert top not in ("segalign_tpu", "bench"), (path, line)


def test_cpu_tensors_launch_no_kernel():
    from segalign_tpu.config import build_substitution_matrix
    from segalign_tpu_torch.ops.extend_fused import extend_fields_program
    from segalign_tpu_torch.ops.first_scan import first_scan
    from segalign_tpu_torch.ops.gather import gather_rows, gather_rows_tile
    from segalign_tpu_torch.ops.window_scan import window_scan
    wrappers = (gather_rows, gather_rows_tile, first_scan, window_scan)
    before = [w.launches for w in wrappers]
    rng = np.random.default_rng(0)
    n, pad = 3000, 2048
    seq = np.full(n + 2 * pad, 6, np.uint8)
    seq[pad:pad + n] = rng.integers(0, 4, n)
    seq[pad + 1000:pad + 1600] = seq[pad + 100:pad + 700]
    t = torch.from_numpy(seq)
    loc_r = torch.tensor([100, 200, 2990], dtype=torch.int32)
    loc_q = torch.tensor([1000, 1100, 5], dtype=torch.int32)
    sub = torch.from_numpy(
        build_substitution_matrix(910).reshape(-1).astype(np.int32))
    out = extend_fields_program(t, t, loc_r, loc_q, 3, sub, 910, 1000, n, n,
                                pad=pad, qtile=True, rtile=True)
    assert out["candidate"].tolist() == [True, True, False]
    assert [w.launches for w in wrappers] == before
