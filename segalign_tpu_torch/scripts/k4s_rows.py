"""K4 on the sequences (window_scan_seq, K4s) beside the survivor steps it
took the place of, on the programs of a pass of the benchmark's first cell.

    python -m segalign_tpu_torch.scripts.k4s_rows [label]

One map_chunks pass over the repeat-1x pair (every chunk-strand,
bench_inputs' settings, as the cell runs it) with each extension
program's continuation inputs kept: its anchors and the states K1 on the
sequences leaves. Then, for those programs:

  steps     the host-stepped form K4s replaced (run_survivors of each
            direction: the rows still alive, at most SURVIVOR_ROWS a step,
            a gather of each sequence and a K4 a step), run through the
            kernels; its rows a step as a histogram, and each program's
            states after it, which K4s's must equal field by field
  device    the pass's continuations replayed from CUDA graphs: every
            program's K4s launch (each after a copy that restores its
            states, the copies timed alone and taken off), and every
            survivor step's K2, K2 and K4 launches; the median of five
            replays
  host      the same continuations run eagerly, one program after another,
            synchronised once at the end: the stepped form (its syncs and
            index ops included) and the K4s wrapper (restores taken off)

Prints the card and one JSON line a measurement. `label` names the tree.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import torch

from . import print_card, require_cuda
from .. import _build, bench_inputs
from ..io.encode import revcomp_codes
from ..ops import extend_fused
from ..ops.extend3 import STATE_KEYS
from ..ops.gather import gather_rows
from ..ops.window_scan import window_scan, window_scan_seq
from ..pipeline.device import DeviceAligner


def graph_ms(fn, reps: int = 1) -> float:
    """Device time of `reps` calls of fn recorded once into a CUDA graph
    and replayed: the median of five replays, over reps."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[2]


def wall_ms(fn) -> float:
    """Host wall of fn, synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


class Program:
    """One program's continuation inputs: its states in one byte buffer
    (views, so that one copy restores them) and a saved copy."""

    def __init__(self, args, st_r, st_l, kw):
        self.args, self.kw = args, kw
        # each field at a 16-byte offset
        nb = sum(-(-v.numel() * v.element_size() // 16) * 16
                 for v in st_r.values())
        self.buf = torch.empty(2 * nb, dtype=torch.uint8,
                               device=st_r["done"].device)
        self.states, o = [], 0
        for st in (st_r, st_l):
            views = {}
            for k in STATE_KEYS:
                size = st[k].numel() * st[k].element_size()
                views[k] = self.buf[o:o + size].view(st[k].dtype).view(
                    st[k].shape)
                views[k].copy_(st[k])
                o += -(-size // 16) * 16
            self.states.append(views)
        self.saved = self.buf.clone()

    def restore(self):
        self.buf.copy_(self.saved)

    def k4s(self):
        ref, query, lr, lq, sub, xdrop, n_r, n_q = self.args
        window_scan_seq(ref, query, lr, lq, *self.states, sub, xdrop, n_r,
                        n_q, **self.kw)


def stepped(p: Program, calls: list, rows: list) -> list:
    """The survivor loop of both directions on copies of p's states,
    through K2 and K4, each step's calls appended to `calls` and its rows
    to `rows`. Returns the two states it leaves."""
    ref, query, lr, lq, sub, xdrop, n_r, n_q = p.args
    W, tile, wc = p.kw["W"], p.kw["tile"], p.kw["with_counts"]
    pad = p.kw["pad"]
    out = []
    for st0, left in zip(p.states, (False, True)):
        st = {k: v.clone() for k, v in st0.items()}
        idx = torch.nonzero(~st["done"]).squeeze(1)
        t = tile
        while idx.numel():
            off = -t - W if left else t
            alive = []
            for part in idx.split(extend_fused.SURVIVOR_ROWS):
                lrp, lqp = lr[part], lq[part]
                cst = {k: st[k][part] for k in STATE_KEYS}
                call = (pad + lrp + off, pad + lqp + off, lrp, lqp, cst, t,
                        left)
                calls.append(call)
                rows.append((left, part.numel()))
                new = step(p, call)
                for k in STATE_KEYS:
                    st[k][part] = new[k]
                alive.append(part[~new["done"]])
            idx = torch.cat(alive)
            t += W
        out.append(st)
    return out


def step(p: Program, call):
    """One survivor step's K2, K2 and K4."""
    ref, query, _, _, sub, xdrop, n_r, n_q = p.args
    sr, sq, lrp, lqp, cst, t, left = call
    W = p.kw["W"]
    r = gather_rows(ref, sr, W)
    q = gather_rows(query, sq, W)
    return window_scan(r, q, lrp, lqp, cst, sub, xdrop, t, n_r, n_q, W=W,
                       left=left, with_counts=p.kw["with_counts"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    label = argv[0] if argv else "tree"
    dev = require_cuda("k4s_rows")
    card = print_card("k4s_rows")
    _build.kernels()
    ref, query = bench_inputs.load_inputs()
    al = DeviceAligner(**bench_inputs.aligner_settings(dev))
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    work = bench_inputs.chunk_work(query)

    programs = []
    real = extend_fused.window_scan_seq

    def keep(ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub, xdrop,
             ref_len, query_len, **kw):
        programs.append(Program(
            (ref_pad, query_pad, loc_r.clone(), loc_q.clone(), sub, xdrop,
             ref_len, query_len), st_r, st_l, kw))
        return real(ref_pad, query_pad, loc_r, loc_q, st_r, st_l, sub,
                    xdrop, ref_len, query_len, **kw)

    extend_fused.window_scan_seq = keep
    try:
        results = al.map_chunks(work, depth=bench_inputs.DEPTH)
    finally:
        extend_fused.window_scan_seq = real
    torch.cuda.synchronize()   # the dispatch thread's stream too
    hsps = sum(len(r.hsps) for r in results)

    # the stepped form through the kernels, held to K4s's states
    calls, rows, by_program = [], [], []
    for p in programs:
        n_calls = len(calls)
        want = stepped(p, calls, rows)
        by_program.append(calls[n_calls:])
        p.restore()
        p.k4s()
        for w, g in zip(want, p.states):
            for k in STATE_KEYS:
                if not torch.equal(w[k], g[k]):
                    raise SystemExit(f"k4s_rows: {label}: K4s's {k} differs "
                                     f"from the survivor steps'")
        p.restore()
    hist = collections.Counter()
    for _, n in rows:
        hist[1 << (n - 1).bit_length()] += 1
    per_dir = {d: [n for left, n in rows if left == (d == "left")]
               for d in ("right", "left")}
    print(json.dumps(dict(
        tree=label, what="pass", chunk_strands=len(work), hsps=hsps,
        programs=len(programs), steps=len(rows),
        steps_by_direction={d: len(v) for d, v in per_dir.items()},
        rows_by_direction={d: sum(v) for d, v in per_dir.items()},
        max_step_rows=max((n for _, n in rows), default=0),
        programs_with_no_step=sum(not c for c in by_program),
        step_rows_histogram={f"<= {k}": v for k, v in sorted(hist.items())},
        card=card)), flush=True)

    def all_k4s():
        for p in programs:
            p.restore()
            p.k4s()

    def all_restores():
        for p in programs:
            p.restore()

    def all_steps():
        for p, cs in zip(programs, by_program):
            for c in cs:
                step(p, c)

    def all_stepped_eager():
        sink_c, sink_r = [], []
        for p in programs:
            stepped(p, sink_c, sink_r)

    restore_ms = graph_ms(all_restores)
    k4s_ms = graph_ms(all_k4s) - restore_ms
    steps_ms = graph_ms(all_steps)
    print(json.dumps(dict(
        tree=label, what="device ms a pass", programs=len(programs),
        k4s=k4s_ms, k2_k4_steps=steps_ms, launches_k4s=len(programs),
        launches_k2_k4=3 * len(rows), restores=restore_ms, card=card)),
        flush=True)
    host = {}
    for rep in range(3):
        r_ms = wall_ms(all_restores)
        host.setdefault("k4s", []).append(wall_ms(all_k4s) - r_ms)
        host.setdefault("stepped", []).append(wall_ms(all_stepped_eager))
    print(json.dumps(dict(
        tree=label, what="host ms a pass (3 runs, eager, one sync)",
        programs=len(programs), **host, card=card)), flush=True)


if __name__ == "__main__":
    main()
