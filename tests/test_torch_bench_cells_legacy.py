"""The legacy-planted cell of the benchmark on the CPU against the root bench.py's
(test_torch_bench_cells.check_cell)."""

import pytest

from test_torch_bench_cells import check_cell


@pytest.mark.parametrize("name", ["legacy-planted"])
def test_run_config_matches_jax(name, tmp_path, monkeypatch):
    check_cell(name, tmp_path, monkeypatch)
