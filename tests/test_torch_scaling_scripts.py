"""The port's scaling scripts (segalign_tpu_torch/scripts/measure_scaling.py
with _scaling_worker.py, measure_sharded_vs_replicated.py) run end to end
on the CPU at a small size: every part must print its parity line, and
the workers' results must come together as one run's. Their times on the
CPU measure nothing; on the card chip_smoke.py phase 4 runs them."""

import numpy as np
import pytest
import torch

from segalign_tpu_torch.scripts import _scaling_worker, measure_scaling, \
    measure_sharded_vs_replicated


def test_measure_scaling_parity(capsys):
    out = measure_scaling.main(["--device", "cpu", "--n", "30000",
                                "--chunk", "8192", "--counts", "1,2"])
    said = capsys.readouterr().out
    assert "parity: identical (farm" in said
    assert "parity: identical (two hosts" in said
    assert [r["aligners"] for r in out["farm"]["rows"]] == [1, 2]
    assert out["farm"]["hsps"] > 0
    # two hosts, each with its half of the chunks
    assert len(out["split"]["hosts"]) == 2


def test_measure_sharded_vs_replicated_parity(capsys):
    out = measure_sharded_vs_replicated.main(
        ["--device", "cpu", "--n", "30000", "--chunk", "16384"])
    said = capsys.readouterr().out
    assert "parity: identical" in said
    names = [r["name"] for r in out["rows"]]
    assert names[:3] == ["replicated", "sharded S=2", "sharded S=4"]
    assert names[3].startswith("2 processes x 1 shard (gloo")
    assert "through host memory" not in names[3]


def test_make_pair_copy_matches():
    """measure_scaling.make_pair is scripts/measure_scaling.py's."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "measure_scaling.py")
    src = open(path).read()
    start = src.index("def make_pair")
    ns = {"np": np}
    exec(src[start:src.index("\n\n\n", start)], ns)
    for n, seed in ((400_000, 5), (30_000, 5), (50_000, 9)):
        for a, b in zip(ns["make_pair"](n, seed),
                        measure_scaling.make_pair(n, seed)):
            np.testing.assert_array_equal(a, b)
    assert importlib.util.find_spec("segalign_tpu_torch.scripts."
                                    "_scaling_worker") is not None


@pytest.mark.parametrize("script", [measure_scaling,
                                    measure_sharded_vs_replicated])
def test_scripts_need_cuda_unless_cpu(script, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        script.main([])
    assert capsys.readouterr().out == ""


def test_worker_layout(monkeypatch):
    assert _scaling_worker.layout("cpu", 2) == ("cpu", "gloo", False)
    assert _scaling_worker.layout("cuda:0", 2) == ("cuda:0", "gloo", False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert _scaling_worker.layout("cuda", 4) == ("cuda:0", "nccl", True)
    with pytest.raises(RuntimeError, match="this machine has 4"):
        _scaling_worker.layout("cuda", 8)


def test_merge_takes_each_chunk_strand_once():
    r = (np.zeros((0, 4), np.int64), 0, 0)
    outs = [dict(idx=[0, 2], results=[r, r]), dict(idx=[1], results=[r])]
    assert len(_scaling_worker.merge(outs, 3)) == 3
    with pytest.raises(RuntimeError, match="by no rank"):
        _scaling_worker.merge(outs, 4)
    with pytest.raises(RuntimeError, match="twice"):
        _scaling_worker.merge(outs + [dict(idx=[1], results=[r])], 3)
