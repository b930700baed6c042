"""window_scan_seq (K4s) on the CPU: the wrapper's argument checks, its
plain version against the host-stepped survivor loop it stands for, and
its place in extend_fields_program. The JAX program holds the fields it
leaves in tests/test_torch_extend_fused.py; the kernel is held to the
plain version by tests/test_torch_cuda.py and chip_smoke.py phase 1."""

import numpy as np
import pytest
import torch

from segalign_tpu_torch.config import build_substitution_matrix
from segalign_tpu_torch.ops import extend_fused, window_scan as ws
from segalign_tpu_torch.ops.extend3 import STATE_KEYS
from segalign_tpu_torch.ops.first_scan import first_scan_seq_plain
from segalign_tpu_torch.ops.launches import launch_counts
from segalign_tpu_torch.ops.window_scan import (window_scan_seq,
                                                window_scan_seq_plain)

SUB = torch.from_numpy(
    build_substitution_matrix(910).reshape(-1).astype(np.int32))
PAD, FIRST_W, W = 2048, 512, 2048


def _inputs(seed, n=30_000, B=300):
    """Padded sequences sharing a 12 kb stretch (rows alive over several
    windows), random and end anchors, and the first windows' states."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(2):
        s = np.full(n + 2 * PAD, 6, np.uint8)
        s[PAD:PAD + n] = rng.integers(0, 4, n)
        seqs.append(s)
    seqs[1][PAD + 4007:PAD + 16007] = seqs[0][PAD + 3000:PAD + 15000]
    lr = rng.integers(0, n + 1, B).astype(np.int32)
    lq = rng.integers(0, n + 1, B).astype(np.int32)
    t = rng.integers(0, 12_000, B // 3)
    lr[:B // 3], lq[:B // 3] = 3000 + t, 4007 + t
    lr[B // 3:B // 3 + 4] = [0, 3, n, n - 2]
    lq[B // 3:B // 3 + 4] = [n - 1, 1, 5, n]
    ref, query = (torch.from_numpy(s) for s in seqs)
    lr, lq = torch.from_numpy(lr), torch.from_numpy(lq)
    states = first_scan_seq_plain(ref, query, lr, lq,
                                  torch.ones(B, dtype=torch.bool), SUB, 910,
                                  n, n, pad=PAD, W=FIRST_W, with_counts=True)
    return ref, query, lr, lq, states, n


def _clone(states):
    return [{k: v.clone() for k, v in st.items()} for st in states]


@pytest.mark.parametrize("with_counts", [False, True])
def test_plain_version_is_the_stepped_survivor_loop(with_counts):
    """On CPU tensors window_scan_seq is its plain version, which is
    run_survivors of each direction through the wrappers (gather_rows and
    window_scan) step by step, in place, with no launch."""
    ref, query, lr, lq, states, n = _inputs(1)
    assert min(int((~st["done"]).sum()) for st in states) > 50
    want = _clone(states)
    for st, left in zip(want, (False, True)):
        extend_fused.run_survivors(ref, query, lr, lq, st, SUB, 910, n, n,
                                   pad=PAD, tile=FIRST_W, W=W, left=left,
                                   with_counts=with_counts)
    got = _clone(states)
    before = launch_counts()
    out = window_scan_seq(ref, query, lr, lq, *got, SUB, 910, n, n, pad=PAD,
                          tile=FIRST_W, W=W, with_counts=with_counts)
    assert launch_counts(before) == dict.fromkeys(before, 0)
    for w, g, o in zip(want, got, out):
        assert o is g
        for k in STATE_KEYS:
            assert torch.equal(w[k], g[k]), k
        assert bool(g["done"].all())
    # rows that walked several windows
    assert int((got[0]["maxp"] > FIRST_W + 3 * W).sum()) > 10


def test_plain_version_in_steps_of_few_rows(monkeypatch):
    """The plain version's steps cut to SURVIVOR_ROWS rows change no
    field."""
    ref, query, lr, lq, states, n = _inputs(2)
    kw = dict(pad=PAD, tile=FIRST_W, W=W, with_counts=True)
    want = window_scan_seq_plain(ref, query, lr, lq, *_clone(states), SUB,
                                 910, n, n, **kw)
    monkeypatch.setattr(extend_fused, "SURVIVOR_ROWS", 7)
    got = window_scan_seq_plain(ref, query, lr, lq, *_clone(states), SUB,
                                910, n, n, **kw)
    for w, g in zip(want, got):
        for k in STATE_KEYS:
            assert torch.equal(w[k], g[k]), k


def test_extend_fields_program_calls_it_once(monkeypatch):
    """extend_fields_program hands both directions' states to one
    window_scan_seq call, at tile W and width W_CONT."""
    ref, query, lr, lq, _, n = _inputs(3)
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return window_scan_seq(*args, **kw)

    monkeypatch.setattr(extend_fused, "window_scan_seq", spy)
    out = extend_fused.extend_fields_program(
        ref, query, lr, lq, len(lr), SUB, 910, 3000, n, n, pad=PAD)
    assert calls == [dict(pad=PAD, tile=512, W=2048, with_counts=False)]
    assert int(out["candidate"].sum()) > 10


def test_launch_counts_lists_it():
    assert "window_scan_seq" in launch_counts()
    assert window_scan_seq.launches >= 0


def _bad(name):
    """Arguments with one thing wrong, and the message it must raise."""
    ref, query, lr, lq, states, n = _inputs(4, n=20_000, B=40)
    st_r, st_l = states
    args = dict(ref=ref, query=query, lr=lr, lq=lq, st_r=st_r, st_l=st_l,
                sub=SUB)
    kw = dict(pad=PAD, tile=FIRST_W, W=W, with_counts=False)
    match = "must be a contiguous"
    if name == "ref dtype":
        args["ref"] = ref.to(torch.int32)
    elif name == "ref 2-D":
        args["ref"] = ref[:4096].view(2, 2048)
    elif name == "query strided":
        args["query"] = torch.cat([query, query])[::2]
    elif name == "loc_q length":
        args["lq"] = lq[:-1]
    elif name == "loc_r int64":
        args["lr"] = lr.long()
    elif name == "sub shape":
        args["sub"] = SUB[:32]
    elif name == "state dtype":
        args["st_l"] = dict(st_l, maxv=st_l["maxv"].long())
    elif name == "state shape":
        args["st_r"] = dict(st_r, counts=st_r["counts"][:, :3].contiguous())
    elif name == "state missing":
        args["st_r"] = {k: v for k, v in st_r.items() if k != "cdel"}
        match = "cdel"
    elif name == "misaligned":
        args["ref"] = torch.cat([ref[:1], ref])[1:]
        match = "16-byte aligned"
    elif name == "W":
        kw["W"] = 2040
        match = "multiple of 16"
    elif name == "short sequence":
        args["query"] = query[:1024]
        match = "fewer than"
    elif name == "too many rows":
        match = "at most"
    return args, kw, match


@pytest.mark.parametrize("name", [
    "ref dtype", "ref 2-D", "query strided", "loc_q length", "loc_r int64",
    "sub shape", "state dtype", "state shape", "state missing",
    "misaligned", "W", "short sequence", "too many rows"])
def test_argument_checks(name, monkeypatch):
    """Each wrong argument raises before anything runs, and no state
    changes."""
    args, kw, match = _bad(name)
    if name == "too many rows":
        monkeypatch.setattr(ws, "MAX_SEQ_ROWS", 40)
    kept = [{k: v.clone() for k, v in st.items()}
            for st in (args["st_r"], args["st_l"])]
    with pytest.raises((ValueError, KeyError), match=match):
        window_scan_seq(args["ref"], args["query"], args["lr"], args["lq"],
                        args["st_r"], args["st_l"], args["sub"], 910,
                        20_000, 20_000, **kw)
    for st, k0 in zip((args["st_r"], args["st_l"]), kept):
        for k, v in st.items():
            assert torch.equal(v, k0[k]), k
