"""K1 on the sequences (first_scan_seq) alone, on the rows chip_smoke.py
phase 1 gives it, for a tree against another in one call.

    python -m segalign_tpu_torch.scripts.k1s_rows [label]

Run it from the root of each tree (the package is imported from the
working directory), in turns, with a label naming the tree. The rows,
B = 2^17 each, at W = 512 and 256 with the match counts off and on:

  hits     the first 2^17 hits of chunk 0's forward strand of the
           repeat-1x pair (the host seeder's, query-sorted) on the padded
           sequences with 800 walls (code 7) set into each, as phase 1
           draws them; the last 100 rows not valid
  no_drop  anchors into one random ACGT sequence of the pair's length,
           given as both reference and query, each anchor the same on
           both: every window pair is equal, so no row drops and every
           lane of every row walks the whole recurrence

Each case is first checked equal to first_scan_seq_plain, field by field,
then timed: kernel_ms, 5 calls recorded into a CUDA graph and replayed,
the median of five replays. Prints the card, ptxas's registers for the
kernel where the tree's build log has them, and one JSON line a case.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from . import print_card, require_cuda
from .. import _build, bench_inputs
from ..io.encode import revcomp_codes
from ..native import ChunkSeeder
from ..ops.first_scan import first_scan_seq, first_scan_seq_plain
from ..pipeline.device import FIRST_W, PAD, DeviceAligner

B = 1 << 17


def graph_ms(fn, reps: int = 5) -> float:
    """Device time of one call: `reps` calls in a CUDA graph, replayed;
    the median of five replays."""
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    label = argv[0] if argv else "tree"
    dev = require_cuda("k1s_rows")
    card = print_card("k1s_rows")
    _build.kernels()
    try:
        for line in _build.kernel_resources("first_scan_seq_kernel"):
            print(f"k1s_rows: ptxas {line}", flush=True)
    except (AttributeError, OSError):
        print("k1s_rows: this tree's build keeps no ptxas log", flush=True)

    ref, query = bench_inputs.load_inputs()
    al = DeviceAligner(**bench_inputs.aligner_settings(dev))
    al.set_ref(ref)
    al.set_query(query, revcomp_codes(query))
    n_r, n_q, sub = al.ref_len, al.q_len, al.sub
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    ref_w, q_w = al.ref_pad.clone(), al.q_fw.clone()
    for t, n in ((ref_w, n_r), (q_w, n_q)):
        t[torch.randint(PAD, PAD + n, (800,), device=dev, generator=gen)] = 7
    index_table, pos_table = al._host_tables
    hits = ChunkSeeder(bench_inputs.CHUNK, al.kmer_size, al.transition).seed(
        al._q_fw_host, 0, bench_inputs.CHUNK, index_table, pos_table,
        al.shape_pos, al.seed_size, al.max_hits)
    if hits[5] < B:
        raise SystemExit(f"k1s_rows: chunk 0 has {hits[5]} hits, fewer "
                         f"than {B}")
    loc_r = torch.from_numpy(hits[0][:B]).to(dev)
    loc_q = torch.from_numpy(hits[1][:B]).to(dev)
    valid = torch.arange(B, device=dev) < B - 100

    rng = np.random.default_rng(2024)
    same = al.ref_pad.clone()
    same[PAD:PAD + n_r] = torch.from_numpy(
        rng.integers(0, 4, n_r).astype(np.uint8)).to(dev)
    loc_s = torch.from_numpy(
        rng.integers(0, n_r, B).astype(np.int32)).to(dev)
    all_valid = torch.ones(B, dtype=torch.bool, device=dev)

    cases = dict(hits=(ref_w, q_w, loc_r, loc_q, valid, n_r, n_q),
                 no_drop=(same, same, loc_s, loc_s, all_valid, n_r, n_r))
    for rows, (r, q, lr, lq, ok, nr, nq) in cases.items():
        for W in (FIRST_W, 256):
            for wc in (False, True):
                args = (r, q, lr, lq, ok, sub, al.xdrop, nr, nq)
                kw = dict(pad=PAD, W=W, with_counts=wc)
                want = first_scan_seq_plain(*args, **kw)
                got = first_scan_seq(*args, **kw)
                for g, w in zip(got, want):
                    for k in w:
                        if not torch.equal(g[k], w[k]):
                            raise SystemExit(
                                f"k1s_rows: {label} {rows} W={W} "
                                f"counts={wc}: {k} differs from the "
                                f"plain version")
                alive = [int((~w["done"]).sum()) for w in want]
                ms = graph_ms(lambda: first_scan_seq(*args, **kw))
                print(json.dumps(dict(
                    tree=label, rows=rows, B=B, W=W, counts=wc,
                    kernel_ms=ms, alive_right=alive[0],
                    alive_left=alive[1], card=card)), flush=True)


if __name__ == "__main__":
    main()
