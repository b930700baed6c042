"""Drive the port's paths once on one NVIDIA GPU and check them: the
pairwise ungapped main path on both seeding routes, the repeat masker, and
the measurement scripts with their kernels (S1-S4).

    python3 chip_smoke.py

Phases, each printing its findings; any failure exits non-zero before the
last line, and without CUDA the script fails at once:

  0. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, nvcc, and the build times of the CUDA kernels and of
     the native host library (both built from this checkout);
  1. every kernel of the paths against its plain PyTorch version on the
     card, at the shapes the paths give it, with exact equality (the
     values are integers), and each one's time (kernel_ms) beside the
     plain version's (plain_ms; CUDA events, after a warmup, measured
     plain, kernel, kernel, plain), its bound (bound_ms: the bytes this
     run's inputs make it read and write over the card's memory rate, or
     its operations over the card's rate if that is more; a first window's
     lanes past its row's first drop, found by the plain walk, count only
     the sum's operations) and, where one
     PyTorch call computes the same function, that call's time
     (library_ms: an advanced index for the gathers, x * 2 for scale2;
     the port never calls it);
     K1 (first_scan) and K3 (gather_rows_tile) also at the narrower first
     window the benchmark's engine parity runs, W = 256 (K1 on 2^17 rows,
     counts off and on; K3 at 2W = 512 on the query-sorted and clustered
     starts), timed into their rows' "variants"; K1 on the sequences
     (first_scan_seq, the paths' first window) on the same 2^17 hits at W =
     512 and 256, counts off and on, beside the time of the launches it
     took the place of (K3 on the query, K2 on the reference, then K1:
     replaced_ms), and, checked only, on anchors within W of both ends of
     both sequences;
     K3 also on starts that do not cluster (every row
     reads directly), and, checked only, on tiles whose span is exactly
     T x 128 bytes, one byte under and one over, on starts the clamp
     moves, on a view one byte off a 16-byte boundary and at W = 2048; S1
     also, checked only, on starts at offsets 0, 1, 15, 16 and 1023 of a
     1024-byte slice and at both ends of the range it admits;
     K4 on the sequences (window_scan_seq, K4s: the native route's whole
     continuation of both directions in one launch) from the states K1 on
     the sequences leaves on the same 2^17 hits, counts off and on, and on
     4096 rows that never drop (one sequence as both reference and query,
     each row walked to both ends), beside the time of the launches it took
     the place of (the survivor steps' K2, K2 and K4 on the same rows,
     replayed from a CUDA graph: replaced_ms) and the rows of each step;
     K5 (window_scan_wide, the stepped check engine's scan) at that
     engine's first window (2^17 rows, tile 0, fresh state) and at a
     continuation (16384 rows, tile 2048, half alive); the device route's
     engine on its first hit range (the same 2^17 hits, every row valid,
     counts on): K1s and K4s checked and timed at these shapes, the
     fields of the two held to the stepped engine's (extend_hits_stepped:
     K2, K2 and K5 a step and direction), and the two launches timed
     beside the stepped engine's launches on the same rows (recorded, then
     replayed from a CUDA graph); S1 (gather_dma_only,
     gather_extract_only, gather_dbuf) and S2 (gather_two_sided) at
     exp_gather_variants' shapes (2^17
     windows of 512 bytes), S3/S4 (scale2) on (256, 512) and (8, 128)
     float32;
  2. the slice at full size: DeviceAligner.map_chunks over both strands of
     every 250 kb chunk of bench_inputs' repeat-1x pair (4 Mbp x 4 Mbp,
     rng 2024) with bench_inputs' aligner settings, which must give the
     8351 HSPs the JAX package gives; every kernel's launch count in that
     run is printed, first_scan_seq and window_scan_seq must launch once a
     program each (a replay of the program's CUDA graph counts both), and
     K1 on gathered rows, K2, K3 and K4 must not launch (the path seeds
     on the card and reads every window from the sequences); then the
     serial form (SEGALIGN_OVERLAP=0: seeding, extension and finish in
     turn on one thread) and the default form (the finish on a thread of
     its own) once more each: every chunk-strand's array equal to the
     first run's, both walls printed; then the programs' graph replays
     against extend_program run eagerly on every eighth chunk-strand and
     the last, program after program, and the pack's graph against
     pack_candidates, a serial pass with each
     chunk-strand's programs and pack under set_sync_debug_mode("error")
     (its arrays equal to the first run's), the host time a program
     (median, p90), the serial stages and the re-extended chunk-strands,
     beside the figures before the program graphs (phase 4b's cell
     prints the busy share beside its figure before them);
  2c. the same slice through the farm, MultiDeviceAligner with two
     aligners on cuda:0 (two worker threads and their finishers, one
     stream): every chunk-strand's array equal to phase 2's, every kernel
     launched as often as phase 2 launched it (the wrappers count under
     one lock), no worker failed (the farm's errors and dead workers are
     empty and each aligner did chunks) and no retry pass; its wall beside
     one aligner's, each run twice (farm, one, one, farm);
  2b. the same slice on the device-seeding route
     (DeviceAligner(device_seeding=True)): the same HSP arrays per
     chunk-strand, with first_scan_seq and window_scan_seq launched once
     each a hit range (the stage timer's nrange count) and none of K1 on
     gathered rows, K2, K3, K4 and K5;
  2d. the same slice through the sharded seed table, ShardedAligner with
     four shards on cuda:0: every chunk-strand's HSPs, hit and seed counts
     equal to phase 2b's, first_scan_seq and window_scan_seq launched as
     often as each other and neither K2 nor K5; wall and peak device
     memory beside phase 2b's;
  2e. the same slice through the sharded table across two processes
     (scripts/_scaling_worker.py, sharded mode), two shards each, both on
     cuda:0 over a gloo group (NCCL takes one process a card), whose
     collectives copy through host memory: every rank's HSPs, hits and
     seeds equal to phase 2b's, first_scan_seq and window_scan_seq
     launched as often as each other and neither K2 nor K5 in each worker
     (the counts are per process); each rank's walls (cold,
     warm), the share of a third run spent in the collectives, and peak
     memory a process;
  3. the CLI: python -m segalign_tpu_torch.cli.run_segalign on a FASTA
     pair made from a fixed seed, whose segments file must hash to what
     the JAX CLI (python -m segalign_tpu.cli.run_segalign) writes for it;
  3b. the repeat-masker CLI (segalign_tpu_torch.cli.run_segalign_repeat_
     masker) on a FASTA made from a fixed seed, on both seeding routes:
     each output must hash to what the JAX RM CLI writes for it; every
     process (here and in 3 and 3d), the device route's and the sharded
     table's with the rest, launches first_scan_seq and window_scan_seq as
     often as each other and neither K2 nor K5 (its `stats` event);
  3d. the CLIs' other modes on the same files (the ten CLI processes of
     phases 3, 3b and 3d run at once, each in a directory of its own):
     the pairwise CLI with --num_devices 2 --device cuda:0, and with
     --sharded_table --num_devices 2 --device cuda:0, each hashing to
     phase 3's sha256; the
     RM CLI with --sharded_table --num_devices 2 hashing to phase 3b's;
     the pairwise CLI as host 0 and as host 1 of two (--num_hosts 2
     --host_id N, five intervals), whose lines are disjoint and together
     are the one-host run's; and --gapped_mode native --format maf-, whose
     MAF must hash to what the JAX CLI writes for the pair;
  3c. the repeat masker at real size: run_repeat_masker with RMConfig's
     defaults on the pair's 4 Mbp reference written as a FASTA, on both
     routes, whose interval files must be byte-identical (each route's
     launch counts are printed; the device route launches first_scan_seq
     and window_scan_seq once each a hit range, and neither K2 nor K5);
  3e. the CLIs at genome scale, one process at a time on cuda:0, on
     bench_inputs.write_scale_inputs' FASTAs: the pairwise CLI
     (--nogapped --markend) on scale-8 (8 x 8 Mbp, 8 and 5 records) and
     the RM CLI on scale-4's reference (4 Mbp, 8 records), whose FASTAs
     and outputs must hash to the JAX CLIs' (the SCALE8_* and SCALE4_*
     constants); the pairwise CLI on scale-16 (16 x 16 Mbp, 16
     and 10 records) on the native route, the device route, the farm of
     two aligners and the sharded table of four shards on cuda:0, whose
     outputs must be byte-identical; the RM CLI on scale-16's reference on
     both routes, identical; each run's wall, counts, peak memory and
     launches (from its `stats` event) are printed, and on every route
     first_scan_seq and window_scan_seq must launch, as often as each
     other, and neither K2 nor K5; then, in this process, the engine on a
     sample of scale-16's hit ranges (every range of every eighth
     chunk-strand and of the last) held
     field for field to the stepped check engine (K2 gathers and K5
     steps), the only check of K1s and K4s at scale that does not compare
     one route with the other;
  3f. past one logical hit batch and one target block, each run's `stats`
     printed as in phase 3e: the pairwise CLI on scale-8 with
     --seq_block_size 2000000 --max_hits 131072 (4 target and 5 query
     blocks) on the native route, the device route, two aligners and four
     shards on cuda:0, and the RM CLI on scale-4's reference with
     --seq_block_size 1000000 --max_hits 131072 on both routes and two
     shards, the seven processes at once: each output must hash to what
     the JAX CLI writes for the same options (the SCALE8_SPLIT_* and
     SCALE4_RM_SPLIT_* constants), with max_hits cutting most
     chunk-strands' hits; then block-1000 (bench_inputs: two 500 Mbp
     target blocks of 20 Mbp records, a 1 Mbp query) through the pairwise
     CLI with --wga_chunk_size 500000 on the native route: 2 target
     blocks, every chunk-strand past 2^26 hits and cut by max_hits, the
     bytes the device route wrote for it (BLOCK1000_SHA256), the peak
     memory under NATIVE_PEAK_LIMIT;
  3g. the card's seeding against the host seeder at genome scale: the
     block-500 pair (500 Mbp target, 1 Mbp query) on the native route,
     where on a sample of chunk-strands, the first and the last chunk on
     both strands, the seeds, hits and logical batch ends of the card's
     seeding (_seed_chunk) and every hit the extension programs read
     (_program_hits) must equal native.ChunkSeeder's, the host seeder
     that is on no route; then one map_chunks over the pair, its wall,
     HSPs, launches and peak memory printed;
  4. the measurement scripts, in process with small repetition counts:
     exp_gather_variants.main, probe_env.main and probe_extension.main
     over every probe; any exception fails the run, and each of S1-S4's
     launchers must be launched there; then the scaling scripts' main at
     small sizes on cuda:0 (measure_scaling: the farm at 1 and 2 aligners,
     two hosts' split; measure_sharded_vs_replicated), each of which
     raises unless it prints its parity lines;
  4b. the benchmark: python -m segalign_tpu_torch.bench --device cuda in a
     process of its own with the default settings (no BENCH_* or
     SEGALIGN_* variable), which must give repeat-1x's 8351 HSPs with
     phase 2's seeds and hits in every pass, the JAX package's seeds, hits
     and HSPs on the density sweep and legacy-planted (the gates of
     BENCHMARK.json's cells), cold and steady, the engine parity
     identical:row+roww256:79hsps, a gapped stage of 8351 segments, 8351
     accepted, a serial breakdown that covers at least 80% of its wall,
     first_scan_seq and window_scan_seq launched in every timed pass
     (first_scan_seq in the engine parity's two, at W = 512 and 256) and
     a last line with exactly the JAX bench's keys; each pass's Mbp/s,
     peak memory and launches and the breakdown's stages are printed;
     then the same process with
     SEGALIGN_DEVICE_SEEDING=1 (the device-seeding route, which the
     aligner reads), held to the same counts, parity and gapped stage,
     with first_scan_seq and window_scan_seq launched in every pass and
     K2 and K5 in none; then the benchmark's first
     cell as BENCHMARK.json runs it (python -m segalign_tpu_torch.bench
     --cell pair-repeat1x-4M-native), which must pass its gate (the JAX
     package's counts and HSP digest, and the rescoring), print every
     metric and launch first_scan_seq and window_scan_seq in a pass;
  5. the kernels as one JSON line, then the result as the last line.

Imports torch, numpy, the standard library and segalign_tpu_torch, nothing
else: no jax and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# sha256 of `segalign_tpu.cli.run_segalign ref.fa query.fa --nogapped
# --output out.segments --markend` on write_cli_pair's files
CLI_SHA256 = ("b22745639ef85cc28e256df51fcea5fb"
              "343cc6d46ea460e791265720ff7b6965")
# sha256 of `segalign_tpu.cli.run_segalign_repeat_masker seq.fa --output
# out.seg --markend` on write_rm_genome's file
RM_CLI_SHA256 = ("1fc0f6b707ea7caa71c6ffa90efa9fa5"
                 "1cc47817aabff211cfcade08ab90a80e")
# sha256 of `segalign_tpu.cli.run_segalign ref.fa query.fa --gapped_mode
# native --format maf- --output out.maf` on write_cli_pair's files
GAPPED_CLI_SHA256 = ("2a6c4edba60baf6d41efdef1f191548a"
                     "b3f3d284e2340b3dd1a5a1d338f2e9a8")
# genome length of phase 3c (the repeat-1x reference, not cut)
RM_REAL_LEN = 4_000_000
# phase 3e: sha256 of bench_inputs.write_scale_inputs' FASTAs (scale-8's
# pair, scale-4's reference) and of what the JAX repeat masker writes for
# scale-4's, computed on the CPU with `segalign_tpu.cli.
# run_segalign_repeat_masker ref4.fa --output out.seg --markend`, with its
# interval count (the JAX repeat masker did not finish on scale-8's
# reference within two hours on a CPU; on scale-4's it took 43 minutes);
# the JAX pairwise CLI's output on scale-8 (its sha256 and HSPs) is the
# gate of the benchmark's cli-scale8-native cell in BENCHMARK.json, with
# the command that gave it
SCALE8_REF_SHA256 = ("7592366ee4ff0d25ca2c3eed94249e90"
                     "b510fc637f3bfe8cc667feb40a5206a3")
SCALE8_QUERY_SHA256 = ("fa02bf45420ce123bca73a5f438f06c7"
                       "a69dd51a9638bcc992a5198e3ab873b4")
SCALE4_REF_SHA256 = ("e911c3a79635be3c3203c7c323568acf"
                     "5f1c5b3f717cf8af7a5c3e861ac9dcee")
SCALE4_RM_SHA256 = ("abbcda35b6dc97862c2d2a1faf43a3f0"
                    "bd6dfa13122dbd61f0b610c3345529e5")
SCALE4_INTERVALS = 1009
SCALE_CLI_TIMEOUT = 300
# phase 3f: the scale-8 pair with --seq_block_size 2000000 (4 target and
# 5 query blocks) and scale-4's reference through the RM CLI with
# --seq_block_size 1000000, both with --max_hits SPLIT_MAX_HITS (most
# chunk-strands' hits cut into several logical batches): sha256 of what the
# JAX CLIs write for them on the CPU (JAX_PLATFORMS=cpu python -m
# segalign_tpu.cli.run_segalign ref8.fa qry8.fa --nogapped --markend
# --seq_block_size 2000000 --max_hits 131072 --output out.segments, and
# segalign_tpu.cli.run_segalign_repeat_masker ref4.fa --markend
# --seq_block_size 1000000 --max_hits 131072 --output out.seg), with their
# HSP and interval counts (on an 8-core CPU, both at once: 58 and 48 min)
SPLIT_MAX_HITS = 131072
SCALE8_SPLIT_SHA256 = ("adf9a18e824586714c286428df27db49"
                       "9621793539096a817586cc64c6edd96e")
SCALE8_SPLIT_HSPS = 16708
SCALE4_RM_SPLIT_SHA256 = ("d88d6f9f102fdc35a722a513c66eeb14"
                          "a087757071b3b941122e9e02cda3c9a2")
SCALE4_RM_SPLIT_INTERVALS = 1017
# block-1000 (two 500 Mbp target blocks, a 1 Mbp query) through the
# pairwise CLI (--nogapped --markend --wga_chunk_size 500000) on the native
# route: its output must hash to what the device route wrote for it on an
# H100 (SEGALIGN_DEVICE_SEEDING=1, 206900 HSPs; the native route wrote the
# same bytes in that run), and its peak device memory may not pass
# NATIVE_PEAK_LIMIT: the seed tables of one 500 Mbp block, with which the
# card seeds (a position table of at most 4 bytes a base and the 4^12
# int32 index table), and 1.5 GiB (the programs' candidates). The counts
# of the repeat-1x pair, the density sweep and legacy-planted and
# scale-8's CLI output are the gates of BENCHMARK.json's cells
# (bench_cells reads them), which the benchmark holds the port to as well.
BLOCK1000_SHA256 = ("d7a0656f31e9c5a8da322c051e1b17e4"
                    "897951b39499858d3324f30c3f73aac1")
BLOCK1000_HSPS = 206900
BLOCK1000_TIMEOUT = 300
NATIVE_PEAK_LIMIT = 1.5 * 2**30 + 4 * 500_000_000 + 4 * 4**12
# the engine parity of the JAX bench on the repeat-1x pair
PARITY = "identical:row+roww256:79hsps"
# the keys of the JAX bench's last line
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "cold_s", "densities",
              "engine_parity", "kernel_fraction", "breakdown",
              "e2e_overlapped_mbps", "legacy_planted_mbps"}
BENCH_TIMEOUT = 600


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def write_cli_pair(d: str):
    """A two-chromosome FASTA pair from a fixed seed: planted homologies at
    85-95% identity on both strands, soft-masked runs and N gaps."""
    import numpy as np
    from segalign_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(77)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = [rng.integers(0, 4, n) for n in (120_000, 80_000)]
    qry = [rng.integers(0, 4, n) for n in (90_000, 60_000)]
    for k in range(12):
        src = ref[k % 2]
        ln = int(rng.integers(800, 6000))
        s = int(rng.integers(0, len(src) - ln))
        dst = qry[k % 2]
        t = int(rng.integers(0, len(dst) - ln))
        piece = src[s:s + ln].copy()
        mut = rng.random(ln) < rng.uniform(0.05, 0.15)
        piece[mut] = (piece[mut] + rng.integers(1, 4, mut.sum())) % 4
        if k % 3 == 2:
            piece = 3 - piece[::-1]   # reverse complement in 0..3 codes
        dst[t:t + ln] = piece

    def text(codes, masks, ns):
        s = bytearray(acgt[codes].tobytes())
        for a, ln in masks:
            s[a:a + ln] = s[a:a + ln].lower()
        for a, ln in ns:
            s[a:a + ln] = b"N" * ln
        return s.decode()

    write_fasta(os.path.join(d, "ref.fa"),
                [("chrA", text(ref[0], [(5000, 700)], [(60_000, 300)])),
                 ("chrB", text(ref[1], [(20_000, 1500)], []))])
    write_fasta(os.path.join(d, "query.fa"),
                [("q1", text(qry[0], [(40_000, 900)], [(10_000, 200)])),
                 ("q2", text(qry[1], [], [(30_000, 100)]))])


def write_rm_genome(d: str):
    """A three-chromosome FASTA from a fixed seed for the repeat masker:
    interspersed copies of three repeat families at 80-95% identity on
    both strands, soft-masked runs every few kb and N gaps."""
    import numpy as np
    from segalign_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(91)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fams = [rng.integers(0, 4, n) for n in (300, 800, 2000)]
    recs = []
    for k, n in enumerate((100_000, 70_000, 40_000)):
        c = rng.integers(0, 4, n)
        for _ in range(n // 4000):
            fam = fams[int(rng.integers(0, len(fams)))]
            take = int(rng.integers(len(fam) // 2, len(fam) + 1))
            piece = fam[:take].copy()
            mut = rng.random(take) < rng.uniform(0.05, 0.20)
            piece[mut] = (piece[mut] + rng.integers(1, 4, mut.sum())) % 4
            if rng.random() < 0.5:
                piece = 3 - piece[::-1]   # reverse complement in 0..3 codes
            p = int(rng.integers(0, n - take))
            c[p:p + take] = piece
        s = bytearray(acgt[c].tobytes())
        p = int(rng.integers(0, 3000))
        while p < n:
            ln = int(rng.integers(30, 300))
            s[p:p + ln] = s[p:p + ln].lower()
            p += ln + int(rng.integers(1500, 4500))
        for _ in range(2):
            a, ln = int(rng.integers(0, n - 500)), int(rng.integers(100, 500))
            s[a:a + ln] = b"N" * ln
        recs.append((f"chr{k + 1}", s.decode()))
    write_fasta(os.path.join(d, "seq.fa"), recs)


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time of one call: `reps` calls recorded once into a CUDA graph
    and replayed, so that the host's time for a call (a wrapper's checks and
    allocations) does not bound the reading. The median of five replays."""
    import torch
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


def _time_pair(kernel, plain, reps):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = _ms(plain, reps)
    k1 = _ms(kernel, reps)
    k2 = _ms(kernel, reps)
    p2 = _ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _err(a, b):
    if not a.numel():
        return 0
    if a.is_floating_point():
        return float((a - b).abs().max().item())
    return int((a.long() - b.long()).abs().max().item())


def _state_err(a, b) -> int:
    return max(_err(a[k], b[k]) for k in a)


# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate of the non-tensor units, taken for the integer
# operations of the scans, which run on the same units.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# operations a scanned lane needs: a table lookup, an add, a max, a
# subtract and two compares; past its row's first drop only the lookup and
# the add; with the match counts a compare, a select and two adds more
SCAN_OPS, SUM_OPS, COUNT_OPS = 6, 2, 4
STATE_BYTES = 45   # done 1, cum, maxv, maxp 4 each, counts and cdel 16 each


# a cell-1 pass's figures before the programs became graph replays
# (PERF.md, the native pair on an NVIDIA H100 80GB HBM3 at 700 W): host
# time a program, serial stages (median, s) and the busy share
BEFORE_PROGRAM_US = 1000
BEFORE_SERIAL_S = dict(extend=0.136, seeds=0.058, pack=0.024,
                       host_dedup=0.014, plan=0.007)
BEFORE_BUSY_SHARE = (0.080, 0.121)


def check_program_graphs(al, work, env, card):
    """Phase 2's check of the native route's programs as CUDA graphs
    (pipeline/program.py): on every eighth chunk-strand and the last, each
    program's count and candidate rows from the graph's replay against
    extend_program run eagerly on the card, and the pack's graph against
    pack_candidates run eagerly; one serial pass whose
    chunk-strands run from their first program to their pack under
    torch.cuda.set_sync_debug_mode("error"); the host time of a program
    (a default pass's extend spans, median and p90), the serial stages
    (SEGALIGN_SYNC=1 and SEGALIGN_OVERLAP=0, the per-layer pass's form).
    Returns (the sync-checked pass's results, a printable summary)."""
    import numpy as np
    import torch
    from segalign_tpu_torch.pipeline import device as devmod
    from segalign_tpu_torch.pipeline.program import pack_candidates

    def snapshots(s, runner):
        snaps = []

        def program(rev):
            run = runner(rev)

            def step(rows):
                run(rows)
                n = int(al._buf.n)
                snaps.append((n, al._buf.rows[:n].clone()))
            return step

        al._program = program
        try:
            al._dispatch_rows(s)
        finally:
            del al._program
        return snaps

    n_prog = n_rows = 0
    for w in work[::8] + work[-1:]:
        s = al._seed_chunk(w.chunk_start, w.chunk_end, w.rev, w.window,
                           into=al._buffers())
        if not s.num_hits:
            continue
        graphed = snapshots(s, al._program)
        eager = snapshots(s, lambda rev: lambda rows: al._program_fn(rev)())
        if len(graphed) != len(eager) or any(
                a != b or not torch.equal(ra, rb)
                for (a, ra), (b, rb) in zip(graphed, eager)):
            fail(f"chunk {w.chunk_start}:{w.chunk_end} rev={w.rev}: the "
                 f"programs' graph replays differ from extend_program run "
                 f"eagerly")
        n_prog += len(graphed)
        n_rows += graphed[-1][0]
        (out, counts), (want, want_counts) = (
            al._pack(), pack_candidates(al._buf, al._kept_rows))
        kept = int(want_counts[0])
        if not torch.equal(counts, want_counts) or \
                not torch.equal(out[:kept], want[:kept]):
            fail(f"chunk {w.chunk_start}:{w.chunk_end} rev={w.rev}: the "
                 f"pack's graph replay differs from pack_candidates run "
                 f"eagerly")

    extend = al._extend_seeded

    def sync_checked(s):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return extend(s)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    al._extend_seeded = sync_checked
    try:
        with env(SEGALIGN_OVERLAP="0"):
            checked = al.map_chunks(work)
    finally:
        del al._extend_seeded

    devmod.STAGE_SPANS = spans = []
    try:
        al.map_chunks(work)
    finally:
        devmod.STAGE_SPANS = None
    us = np.array([(e - b) / 1e3 for name, b, e in spans
                   if name == "extend"])
    med, p90 = np.percentile(us, [50, 90])
    with env(SEGALIGN_SYNC="1", SEGALIGN_OVERLAP="0"):
        devmod.reset_stage_totals()
        t0 = time.time()
        al.map_chunks(work)
        wall = time.time() - t0
        serial = {k: round(v, 4) for k, v in devmod.STAGE_TOTALS.items()}
    return checked, (
        f"program graphs: {n_prog} programs of {len(work[::8]) + 1} "
        f"chunk-strands ({n_rows} candidate rows) and their packs replayed "
        f"equal to extend_program and pack_candidates run eagerly; a "
        f"serial pass from each chunk-strand's "
        f"first program to its pack under set_sync_debug_mode('error') "
        f"raised nothing; host time a program median {med:.1f} us, p90 "
        f"{p90:.1f} us over {len(us)} programs (before the graphs about "
        f"{BEFORE_PROGRAM_US} us); serial stages {serial}, wall "
        f"{wall:.3f} s (medians before the graphs {BEFORE_SERIAL_S}); "
        f"candidate "
        f"rows {al._buf.cand_rows}, kept rows {al._kept_rows}, graph pool "
        f"and caches: memory_reserved "
        f"{torch.cuda.memory_reserved(al.device) / 2**30:.4f} GiB [{card}]")


def bound_ms(nbytes: float, ops: float = 0.0):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def run_clis_logged(jobs: list, timeout: float = SCALE_CLI_TIMEOUT
                    ) -> dict:
    """Run the port's CLIs, all at once, each in a process of its own with
    SEGALIGN_LOG_JSON=1: jobs of (label, module, argv, env, cwd). Fails
    unless every one exits 0 within `timeout` seconds without the farm's
    retry pass. Returns {label: its output bytes and their sha256, its
    wall and the pipeline's `stats` event (seeds, hits, HSPs, the branches
    the run took, the kernels' launches in the process, each card's peak
    memory)}."""
    t0 = time.time()
    procs = []
    try:
        for label, module, argv, env, cwd in jobs:
            shutil.rmtree(cwd, ignore_errors=True)
            os.makedirs(cwd)
            out = os.path.join(cwd, "out.txt")
            procs.append((label, out, subprocess.Popen(
                [sys.executable, "-m", f"segalign_tpu_torch.cli.{module}",
                 *argv, "--output", out], cwd=cwd,
                env=dict(os.environ, PYTHONPATH=ROOT, SEGALIGN_LOG_JSON="1",
                         **env),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)))
        got = {}
        for label, out, p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(timeout - (time.time() - t0), 1))
            except subprocess.TimeoutExpired:
                fail(f"{label} ran past {timeout} s")
            secs = time.time() - t0
            if p.returncode != 0:
                fail(f"{label} exited {p.returncode}:\n{err[-3000:]}")
            if "after device failure" in err:
                fail(f"{label} retried chunks after a device failure:\n"
                     f"{err[-3000:]}")
            stats = [json.loads(ln) for ln in err.splitlines()
                     if ln.startswith("{") and '"event":"stats"' in ln]
            if len(stats) != 1:
                fail(f"{label} logged {len(stats)} stats events")
            with open(out, "rb") as f:
                data = f.read()
            got[label] = dict(data=data,
                              sha256=hashlib.sha256(data).hexdigest(),
                              secs=secs, stats=stats[0])
        return got
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_clis(jobs: list, d: str) -> dict:
    """run_clis_logged of jobs of (label, module, argv, env), each in a
    directory of its own under d, within 600 s. Returns {label: (output
    bytes, sha256, seconds to its exit, the kernels' launches)}."""
    got = run_clis_logged(
        [(label, module, argv, env, os.path.join(d, f"cli_{i}"))
         for i, (label, module, argv, env) in enumerate(jobs)], 600)
    return {k: (v["data"], v["sha256"], v["secs"], v["stats"]["launches"])
            for k, v in got.items()}


def run_cli_logged(label: str, module: str, argv: list, env: dict,
                   cwd: str, timeout: float = SCALE_CLI_TIMEOUT) -> dict:
    """run_clis_logged of one CLI: its output, wall and `stats` event."""
    return run_clis_logged([(label, module, argv, env, cwd)],
                           timeout)[label]


def scale_line(label: str, r: dict, module_is_rm: bool, card: str) -> str:
    """One CLI run of phases 3e and 3f as a line: what it wrote, its
    counts, walls, branches, peak memory, launches and sha256."""
    st = r["stats"]
    what = (f"{r['data'].count(b'\n') - 2} intervals" if module_is_rm
            else f"{r['data'].count(b'\n') - 1} segments")
    peak = st["peak_device_bytes"]
    return (f"{label}: {what}, {st['hsps']} HSPs, {st['seeds']} seeds, "
            f"{st['seed_hits']} hits, process wall {r['secs']:.1f} s "
            f"(ungapped stage {st['seconds']} s, "
            f"{st['seed_hits'] / max(st['seconds'], 1e-9):.3g} hits/s), "
            f"{st['ref_blocks']} target blocks, {st['chunk_strands']} "
            f"chunk-strands, {st['hit_batches']} hit batches, "
            f"{st['split_chunks']} cut by max_hits, hits a chunk-strand "
            f"{st['min_chunk_hits']}-{st['max_chunk_hits']}, "
            f"{st['reextended']} extended again, max_memory_allocated "
            f"{max(peak) / 2**30 if peak else 0:.2f} GiB, launches "
            f"{st['launches']}, sha256 {r['sha256']} [{card}]")


def sha256_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def bench_process(argv: list, route_env: dict = None):
    """python -m segalign_tpu_torch.bench --device cuda *argv in a process
    of its own, with none of the caller's BENCH_* or SEGALIGN_* settings
    but route_env's; fails unless it exits 0 within BENCH_TIMEOUT.
    Returns the finished process, its output captured as text."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SEGALIGN_"))}
    env.update(route_env or {}, PYTHONPATH=ROOT)
    try:
        p = subprocess.run(
            [sys.executable, "-m", "segalign_tpu_torch.bench", "--device",
             "cuda", *argv], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        fail(f"the benchmark ran past {BENCH_TIMEOUT} s:\n"
             f"{(e.stderr or b'')[-3000:]}")
    if p.returncode != 0:
        fail(f"the benchmark exited {p.returncode}:\n{p.stderr[-3000:]}")
    return p


def run_bench(route_env: dict = None) -> dict:
    """Run the benchmark in a process of its own, with none of the caller's
    BENCH_* or SEGALIGN_* settings but route_env's; fail unless it exits 0.
    Returns its passes in order, each a dict of label, launches, peak_gib
    and, but for the engine parity's, counts (seeds, hits, HSPs) and mbps;
    the gapped stage's (segments, accepted); its last line; and its build,
    steady, gapped and overlapped lines."""
    t0 = time.time()
    p = bench_process([], route_env)
    secs = time.time() - t0
    err = p.stderr
    # a pass prints its cell[...] line, then (but for the engine parity's)
    # its bench[...] line
    passes = []
    for ln in err.splitlines():
        m = re.match(r"cell\[([\w.-]+)\]: launches (\{.*?\})"
                     r"(?:, max_memory_allocated ([\d.]+) GiB)?$", ln)
        if m:
            passes.append(dict(label=m[1], launches=json.loads(m[2]),
                               peak_gib=float(m[3]) if m[3] else None,
                               counts=None, mbps=None))
        m = re.match(r"bench\[([\w.-]+)\]: .* \| seeds=(\d+) hits=(\d+) "
                     r"hsps=(\d+) \(.*\) -> ([\d.]+) Mbp/s$", ln)
        if m:
            if not passes or passes[-1]["label"] != m[1]:
                fail(f"the benchmark's bench[{m[1]}] line follows no "
                     f"cell[{m[1]}] line")
            passes[-1].update(counts=tuple(map(int, m.group(2, 3, 4))),
                              mbps=float(m[5]))
    gapped = re.search(r"^gapped stage \(native ydrop\): (\d+) segments "
                       r"in .*?, (\d+) accepted\)", err, re.M)

    def line(prefix):
        found = [ln for ln in err.splitlines() if ln.startswith(prefix)]
        return " | ".join(found) if found else f"no {prefix} line"

    try:
        result = json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        fail(f"the benchmark printed no result line:\n{p.stdout[-2000:]}")
    return dict(passes=passes, result=result, seconds=secs,
                gapped=(tuple(map(int, gapped.groups())) if gapped
                        else None),
                build=line("build:"), steady=line("steady["),
                gapped_line=line("gapped stage"), e2e_line=line("e2e["))


class Kernels:
    """Per-kernel findings of phase 1."""

    def __init__(self):
        self.rows = {}

    def verify(self, name, label, err):
        """Fail unless err is 0; an edge that is checked and not timed."""
        if err != 0:
            fail(f"{name} {label} disagrees with its plain version "
                 f"(max_abs_err {err})")
        print(f"  {name} {label}: max_abs_err={err}", flush=True)
        row = self.rows.setdefault(name, dict(max_abs_err=0))
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def check(self, name, label, err, kernel, plain, reps, nbytes, ops=0.0,
              library=None, variant=None, reset=None):
        """Fail unless err is 0; time the kernel beside its plain version
        (wrapper_ms and plain_ms: back-to-back calls, which read the larger
        of the host's and the card's time for a call), then the kernel
        alone and, where one PyTorch call computes the same function, that
        call (kernel_ms and library_ms: replayed from a CUDA graph); the
        first check of a kernel (its main-path shape) gives its row, and a
        check with a `variant` name goes to the row's "variants". reset:
        what `kernel` and `plain` call first to restore the inputs they
        update in place; its own time, measured the same ways, comes off
        theirs."""
        self.verify(name, label, err)
        wrapper_ms, plain_ms = _time_pair(kernel, plain, reps)
        ms = _graph_ms(kernel, reps)
        if reset is not None:
            eager, graphed = _ms(reset, reps), _graph_ms(reset, reps)
            wrapper_ms, plain_ms = wrapper_ms - eager, plain_ms - eager
            ms -= graphed
        library_ms = None if library is None else _graph_ms(library, reps)
        bms, by = bound_ms(nbytes, ops)
        print(f"  {name} {label}: kernel_ms {ms:.4f}, "
              f"wrapper_ms {wrapper_ms:.4f}, "
              f"plain_ms {plain_ms:.4f}, bound_ms {bms:.4f} ({by}: "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f}e9 operations), "
              f"library_ms "
              + ("none" if library_ms is None else f"{library_ms:.4f}"),
              flush=True)
        row = self.rows[name]
        timing = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by, library_ms=library_ms)
        if variant is not None:
            row.setdefault("variants", {})[variant] = timing
        elif "ms" not in row:
            row.update(timing)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import numpy as np

    sys.path.insert(0, ROOT)
    from segalign_tpu_torch import _build
    from segalign_tpu_torch.native import ChunkSeeder
    from segalign_tpu_torch.ops.first_scan import first_scan, \
        first_scan_plain, first_scan_seq, first_scan_seq_plain
    from segalign_tpu_torch.ops.gather import gather_rows, \
        gather_rows_plain, gather_rows_tile
    from segalign_tpu_torch.ops import gather_variants as gv
    from segalign_tpu_torch.ops.probe import scale2, scale2_plain
    from segalign_tpu_torch.scripts import exp_gather_variants, probe_env, \
        probe_extension, measure_scaling, measure_sharded_vs_replicated, \
        k4s_rows
    from segalign_tpu_torch.scripts._scaling_worker import (launch_faults,
                                                           run_workers)
    from segalign_tpu_torch.ops.extend3 import (STATE_KEYS,
                                                extend_hits_stepped,
                                                extend_hits_windowed,
                                                init_state)
    from segalign_tpu_torch.ops.window_scan import window_scan, \
        window_scan_plain, window_scan_seq, window_scan_seq_plain
    from segalign_tpu_torch.ops.window_scan_wide import window_scan_wide, \
        window_scan_wide_plain
    from segalign_tpu_torch.parallel.multi import MultiDeviceAligner
    from segalign_tpu_torch.parallel.sharded import ShardedAligner
    from segalign_tpu_torch.pipeline import device as device_mod
    from segalign_tpu_torch.pipeline.device import (CONT_W, FIRST_W, PAD,
                                                    ChunkResult,
                                                    DeviceAligner,
                                                    _hit_ranges, _range_hits)
    from segalign_tpu_torch.pipeline.repeat_masker import run_repeat_masker
    from segalign_tpu_torch import bench_cells, bench_inputs
    from segalign_tpu_torch.bench import _env
    from segalign_tpu_torch.config import RMConfig
    from segalign_tpu_torch.io.encode import revcomp_codes
    CHUNK = bench_inputs.CHUNK
    # the gates of the benchmark's cells (BENCHMARK.json), at seed 2024
    cells = bench_cells.cells()
    EXPECTED_HSPS = cells["pair-repeat1x-4M-native"].gate["hsps"]
    SWEEP_COUNTS = {c.inputs: (c.gate["seeds"], c.gate["hits"],
                               c.gate["hsps"]) for c in cells.values()
                    if c.kind == "pair" and c.inputs != "repeat-1x"}
    SCALE8_CLI_SHA256 = cells["cli-scale8-native"].gate["sha256"]
    SCALE8_HSPS = cells["cli-scale8-native"].gate["hsps"]

    dev = torch.device("cuda", 0)

    def engine_faults(launches: dict, ranges=None) -> list:
        """What is wrong with a run's launches on the device route or the
        sharded table: launch_faults' (K1s or K4s not launched, K2 or K5
        launched), and K1s and K4s not launched once each a hit range
        (`ranges`; as often as each other where the ranges are not
        counted)."""
        bad = launch_faults(launches)
        n = (launches["first_scan_seq"], launches["window_scan_seq"])
        if n[0] != n[1] or ranges not in (None, n[0]):
            bad.append(f"first_scan_seq and window_scan_seq launched "
                       f"{n[0]} and {n[1]} times, not once each a hit "
                       f"range ({ranges} ranges)")
        return bad

    def nranges() -> int:
        """The device route's hit ranges since reset_stage_totals (its
        stage timer adds 1e-3 to nrange a range)."""
        return round(device_mod.STAGE_TOTALS.get("nrange", 0.0) * 1e3)

    # ---- phase 0: environment and builds
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True)
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, nvcc: "
          f"{nvcc.stdout.strip().splitlines()[-1]}", flush=True)
    t0 = time.time()
    _build.kernels()
    t_k = time.time() - t0
    t0 = time.time()
    _build.native_lib_path()
    t_n = time.time() - t0
    print(f"build: CUDA kernels {t_k:.1f} s, native host library "
          f"{t_n:.1f} s", flush=True)
    for name in ("first_scan_seq_kernel", "window_scan_seq_kernel"):
        for ln in _build.kernel_resources(name):
            print(f"build: ptxas {ln}", flush=True)

    # ---- the repeat-1x pair and the aligner of phase 2
    t0 = time.time()
    ref, query = bench_inputs.load_inputs()
    qrc = revcomp_codes(query)
    settings = bench_inputs.aligner_settings(dev)
    al = DeviceAligner(**settings)
    al.set_ref(ref)
    al.set_query(query, qrc)
    print(f"inputs: {len(ref)/1e6:.1f} Mbp x {len(query)/1e6:.1f} Mbp, "
          f"seed table and upload {time.time() - t0:.1f} s", flush=True)

    # ---- phase 1: kernels against their plain versions
    print("phase 1: kernels vs plain versions (exact)", flush=True)
    K = Kernels()
    rng = np.random.default_rng(2024)
    pad, W, Wc = PAD, FIRST_W, CONT_W
    W256 = 256   # the first window of the benchmark's engine parity
    n_r, n_q = al.ref_len, al.q_len
    sub = al.sub
    # copies of the padded sequences with walls (code 7) sprinkled in,
    # beside the soft-masked (4) and N (5) runs the pair has
    ref_w, q_w = al.ref_pad.clone(), al.q_fw.clone()
    for t in (ref_w, q_w):
        t[torch.randint(pad, pad + n_r, (800,), device=dev)] = 7
    # real hits: the first 2^17 of chunk 0's forward strand (query-sorted),
    # from the host seeder
    index_table, pos_table = al._host_tables
    hits = ChunkSeeder(CHUNK, al.kmer_size, al.transition).seed(
        al._q_fw_host, 0, CHUNK, index_table, pos_table, al.shape_pos,
        al.seed_size, al.max_hits)
    B = 1 << 17
    if hits[5] < B:
        fail(f"chunk 0 has {hits[5]} hits, fewer than {B}")
    loc_r = torch.from_numpy(hits[0][:B]).to(dev)
    loc_q = torch.from_numpy(hits[1][:B]).to(dev)

    def gather_bytes(seq, rows, width, sides=1):
        """A gather reads each source byte once (no more than the sequence
        holds) and 4 bytes a start, and writes every window."""
        return sides * (min(seq.numel(), rows * width) + 4 * rows
                        + rows * width)

    def index_gather(seq, starts, width):
        """The one PyTorch call that computes a gather: an advanced index
        on the sequence's sliding windows (starts in range, no clamp)."""
        return seq.unfold(0, width, 1)[starts.long()]

    def in_bounds(lr, lq, tile, left, width):
        """The in-bounds lanes of each row's window at `tile`."""
        if left:
            n_inb = torch.minimum(lr, lq).long() - tile
        else:
            n_inb = torch.minimum(n_r - lr.long(), n_q - lq.long()) - tile
        return n_inb.clamp(0, width)

    def scan_work(lr, lq, alive, tile, left, wc, width, full=None):
        """(bytes, operations) a window scan needs on these rows: the
        in-bounds lanes of the alive rows' r and q, every row's anchors
        and state in and out, the table. full: the lanes of each row that
        need the whole recurrence (first_lanes), the rest only the sum;
        every in-bounds lane where None."""
        n_inb = in_bounds(lr, lq, tile, left, width)
        lanes = int(n_inb[alive].sum())
        nbytes = 2 * lanes + lr.numel() * (8 + 2 * STATE_BYTES) + 256
        n_full = lanes if full is None else int(full[alive].sum())
        extra = COUNT_OPS if wc else 0
        return nbytes, (n_full * (SCAN_OPS + extra)
                        + (lanes - n_full) * (SUM_OPS + extra))

    def first_lanes(seq_r, seq_q, lr, lq, width, left, xdrop=910):
        """The lanes of each row's first window (at pad + loc - width, as
        the first scans read it) that need the whole recurrence: the
        in-bounds ones up to and with the row's first drop, from the plain
        walk on these inputs."""
        n_inb = in_bounds(lr, lq, 0, left, width)
        lanes = torch.arange(width, device=dev)
        full = torch.empty_like(n_inb)
        for a in range(0, lr.numel(), 1 << 14):
            rows = slice(a, a + (1 << 14))
            r = gather_rows_plain(seq_r, pad + lr[rows] - width, 2 * width)
            q = gather_rows_plain(seq_q, pad + lq[rows] - width, 2 * width)
            r, q = ((r[:, :width].flip(1), q[:, :width].flip(1)) if left
                    else (r[:, width:], q[:, width:]))
            inb = lanes < n_inb[rows, None]
            cum = torch.cumsum(torch.where(inb, sub[r.long() * 8 + q.long()],
                                           0), 1, dtype=torch.int32)
            m = torch.cummax(cum, 1).values.clamp(min=0)
            drop = inb & (m - cum > xdrop)
            first = torch.where(drop, lanes, width).amin(1)
            full[rows] = torch.minimum(first + 1, n_inb[rows])
        return full

    for Wg in (2 * W, Wc):
        s = torch.from_numpy(rng.integers(
            0, al.ref_pad.numel() - Wg, B).astype(np.int32)).to(dev)
        got = gather_rows(al.ref_pad, s, Wg)
        err = _err(got, gather_rows_plain(al.ref_pad, s, Wg))
        K.check("gather_rows", f"B={B} W={Wg}", err,
                lambda: gather_rows(al.ref_pad, s, Wg),
                lambda: gather_rows_plain(al.ref_pad, s, Wg), 20,
                gather_bytes(al.ref_pad, B, Wg),
                library=lambda: index_gather(al.ref_pad, s, Wg))

    q_start = pad + loc_q - W
    r_start = pad + loc_r - W
    blocks = rng.integers(0, al.ref_pad.numel() - 70_000, B // 128)
    clustered = torch.from_numpy(
        (np.repeat(blocks, 128) + rng.integers(0, 60_000, B)
         ).astype(np.int32)).to(dev)
    scattered = torch.from_numpy(rng.integers(
        0, q_w.numel() - 2 * W, B).astype(np.int32)).to(dev)
    for T, s, label in ((64, q_start, "query-sorted starts T=64"),
                        (512, clustered, "clustered starts T=512"),
                        (64, scattered, "starts that do not cluster T=64 "
                         "(every row direct)")):
        seq = ref_w if T == 512 else q_w
        got = gather_rows_tile(seq, s, 2 * W, T)
        err = _err(got, gather_rows_plain(seq, s, 2 * W))
        K.check("gather_rows_tile", f"B={B} W={2 * W} {label}", err,
                lambda: gather_rows_tile(seq, s, 2 * W, T),
                lambda: gather_rows_plain(seq, s, 2 * W), 20,
                gather_bytes(seq, B, 2 * W),
                library=lambda: index_gather(seq, s, 2 * W))

    # K3 at the engine parity's 2W = 512
    for T, s, label in ((64, pad + loc_q - W256, "query-sorted starts T=64"),
                        (512, clustered, "clustered starts T=512")):
        seq = ref_w if T == 512 else q_w
        got = gather_rows_tile(seq, s, 2 * W256, T)
        err = _err(got, gather_rows_plain(seq, s, 2 * W256))
        K.check("gather_rows_tile", f"B={B} W={2 * W256} {label}", err,
                lambda: gather_rows_tile(seq, s, 2 * W256, T),
                lambda: gather_rows_plain(seq, s, 2 * W256), 20,
                gather_bytes(seq, B, 2 * W256),
                library=lambda: index_gather(seq, s, 2 * W256),
                variant=f"W={2 * W256} T={T}")

    def tile_edge(seq, s, width, T, label):
        s = torch.as_tensor(np.asarray(s, np.int64).astype(np.int32)).to(dev)
        K.verify("gather_rows_tile", f"B={s.numel()} W={width} T={T} {label}",
                 _err(gather_rows_tile(seq, s, width, T),
                      gather_rows_plain(seq, s, width)))

    n_pad = q_w.numel()
    for T in (64, 512):
        for delta in (-1, 0, 1):
            for lo in (1 << 20, (1 << 20) + 5):
                # 64 tiles whose span is T x 128 + delta bytes from lo
                hi = lo + T * 128 - 2 * W + delta
                tile = rng.integers(lo, hi + 1, 128)
                tile[[3, 77]] = [hi, lo]
                tile_edge(q_w, np.concatenate(
                    [tile + 4099 * k for k in range(64)]), 2 * W, T,
                    f"span T x 128 {delta:+d} from {lo}")
    tile_edge(q_w, np.concatenate([
        rng.integers(-5000, 0, 4000), rng.integers(n_pad - 2 * W, n_pad + 5000,
                                                   4000),
        [-2**31, 2**31 - 1, 0, n_pad - 2 * W]]), 2 * W, 64,
        "starts below 0 and above L - W")
    for T, s in ((64, q_start), (512, clustered)):
        tile_edge(q_w[1:], s.cpu().numpy()[:1 << 14], 2 * W, T,
                  "a view one byte off alignment")
        tile_edge(q_w, s.cpu().numpy()[:1 << 14], Wc, T, "")

    r2 = gather_rows(ref_w, r_start, 2 * W)
    q2 = gather_rows(q_w, q_start, 2 * W)
    valid = torch.arange(B, device=dev) < B - 100
    # the first windows' lanes up to each row's drop, for K1's and K1s's
    # operations
    full_lanes = {Wf: {left: first_lanes(ref_w, q_w, loc_r, loc_q, Wf, left)
                       for left in (False, True)} for Wf in (W, W256)}
    first = {}
    for wc in (False, True):
        args = (r2, q2, loc_r, loc_q, valid, sub, 910, n_r, n_q)
        got = first_scan(*args, W=W, with_counts=wc)
        want = first_scan_plain(*args, W=W, with_counts=wc)
        err = max(_state_err(g, w) for g, w in zip(got, want))
        alive = [int((~g["done"]).sum()) for g in got]
        # both halves at tile 0: the state is implicit on entry (9 bytes
        # a row come in: two anchors and the valid flag)
        work = [scan_work(loc_r, loc_q, valid, 0, left, wc, W,
                          full_lanes[W][left]) for left in (False, True)]
        nbytes = sum(w[0] for w in work) - B * (7 + 2 * STATE_BYTES) - 256
        K.check("first_scan", f"B={B} W={W} counts={'on' if wc else 'off'} "
                f"(alive after: right {alive[0]}, left {alive[1]})", err,
                lambda: first_scan(*args, W=W, with_counts=wc),
                lambda: first_scan_plain(*args, W=W, with_counts=wc), 5,
                nbytes, sum(w[1] for w in work))
        first[wc] = got
    del r2, q2
    # K1 at the engine parity's W = 256
    r2 = gather_rows(ref_w, r_start + W - W256, 2 * W256)
    q2 = gather_rows(q_w, q_start + W - W256, 2 * W256)
    for wc in (False, True):
        args = (r2, q2, loc_r, loc_q, valid, sub, 910, n_r, n_q)
        got = first_scan(*args, W=W256, with_counts=wc)
        want = first_scan_plain(*args, W=W256, with_counts=wc)
        err = max(_state_err(g, w) for g, w in zip(got, want))
        alive = [int((~g["done"]).sum()) for g in got]
        work = [scan_work(loc_r, loc_q, valid, 0, left, wc, W256,
                          full_lanes[W256][left]) for left in (False, True)]
        nbytes = sum(w[0] for w in work) - B * (7 + 2 * STATE_BYTES) - 256
        K.check("first_scan", f"B={B} W={W256} "
                f"counts={'on' if wc else 'off'} (alive after: right "
                f"{alive[0]}, left {alive[1]})", err,
                lambda: first_scan(*args, W=W256, with_counts=wc),
                lambda: first_scan_plain(*args, W=W256, with_counts=wc), 5,
                nbytes, sum(w[1] for w in work),
                variant=f"W={W256} counts={'on' if wc else 'off'}")
    del r2, q2

    def covered_bytes(starts, width, lo, hi):
        """The bytes of [lo, hi) that windows [s, s + width) cover, each
        once: what a function must read to see them all."""
        s0 = np.sort(starts.cpu().numpy().astype(np.int64))
        s, e = np.clip(s0, lo, hi), np.clip(s0 + width, lo, hi)
        run_end = np.maximum.accumulate(e)
        # a window starts a new run where it begins past every earlier end
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        ends = np.append(run_end[np.nonzero(new)[0][1:] - 1], run_end[-1])
        return int((ends - s[new]).sum())

    # K1 on the sequences: the same hits, what the paths call
    for Wf in (W, W256):
        # the launches it took the place of: K3 on the query-sorted query
        # windows, K2 on the reference's, K1 on the rows
        def replaced():
            q2 = gather_rows_tile(q_w, pad + loc_q - Wf, 2 * Wf, 64)
            r2 = gather_rows(ref_w, pad + loc_r - Wf, 2 * Wf)
            return first_scan(r2, q2, loc_r, loc_q, valid, sub, 910, n_r,
                              n_q, W=Wf, with_counts=False)
        replaced_ms = _graph_ms(replaced, 5)
        seq_bytes = sum(
            covered_bytes(pad + lc[valid] - Wf, 2 * Wf, pad, pad + n)
            for lc, n in ((loc_r, n_r), (loc_q, n_q)))
        for wc in (False, True):
            args = (ref_w, q_w, loc_r, loc_q, valid, sub, 910, n_r, n_q)
            kw = dict(pad=pad, W=Wf, with_counts=wc)
            got = first_scan_seq(*args, **kw)
            err = max(_state_err(g, w) for g, w in
                      zip(got, first_scan_seq_plain(*args, **kw)))
            alive = [int((~g["done"]).sum()) for g in got]
            # the covered sequence bytes, 9 bytes of anchors and flag a
            # row, both states out; the operations of both halves' lanes
            ops = sum(scan_work(loc_r, loc_q, valid, 0, left, wc, Wf,
                                full_lanes[Wf][left])[1]
                      for left in (False, True))
            label = f"W={Wf} counts={'on' if wc else 'off'}"
            K.check("first_scan_seq",
                    f"B={B} {label} (alive after: right {alive[0]}, left "
                    f"{alive[1]}; sequence bytes covered {seq_bytes})", err,
                    lambda: first_scan_seq(*args, **kw),
                    lambda: first_scan_seq_plain(*args, **kw), 5,
                    seq_bytes + B * (9 + 2 * STATE_BYTES), ops,
                    variant=None if Wf == W else label)
            if not wc:
                row = K.rows["first_scan_seq"]
                ms = (row if Wf == W else row["variants"][label])["ms"]
                print(f"  first_scan_seq B={B} W={Wf}: kernel_ms {ms:.4f} "
                      f"against {replaced_ms:.4f} for the K3 + K2 + K1 "
                      f"launches it took the place of [{card}]", flush=True)
                row.setdefault("replaced_ms", {})[f"W={Wf}"] = replaced_ms
    # rows that never drop: one random ACGT sequence as both reference and
    # query, each anchor the same on both, so every window pair is equal
    # and every lane of every row runs the whole recurrence (the worst
    # case of the thread-a-row walk)
    rng_s = np.random.default_rng(2025)
    same = al.ref_pad.clone()
    same[pad:pad + n_r] = torch.from_numpy(
        rng_s.integers(0, 4, n_r).astype(np.uint8)).to(dev)
    loc_s = torch.from_numpy(rng_s.integers(W, n_r - W, B).astype(
        np.int32)).to(dev)
    all_valid = torch.ones(B, dtype=torch.bool, device=dev)
    for Wf in (W, W256):
        for wc in (False, True):
            args = (same, same, loc_s, loc_s, all_valid, sub, 910, n_r, n_r)
            kw = dict(pad=pad, W=Wf, with_counts=wc)
            got = first_scan_seq(*args, **kw)
            err = max(_state_err(g, w) for g, w in
                      zip(got, first_scan_seq_plain(*args, **kw)))
            if any(bool(g["done"].any()) for g in got):
                fail("first_scan_seq: a row of equal windows dropped")
            ops = sum(scan_work(loc_s, loc_s, all_valid, 0, left, wc, Wf,
                                first_lanes(same, same, loc_s, loc_s, Wf,
                                            left))[1]
                      for left in (False, True))
            label = f"never drop W={Wf} counts={'on' if wc else 'off'}"
            K.check("first_scan_seq", f"B={B} {label}", err,
                    lambda: first_scan_seq(*args, **kw),
                    lambda: first_scan_seq_plain(*args, **kw), 5,
                    covered_bytes(pad + loc_s - Wf, 2 * Wf, pad, pad + n_r)
                    + B * (9 + 2 * STATE_BYTES), ops, variant=label)
    del same
    # anchors within W of both ends of both sequences, checked only
    edges = np.array([0, 1, 15, 16, 17, W - 1, W, W + 1])
    e_r = np.concatenate([edges, n_r - edges, edges, n_r - edges])
    e_q = np.concatenate([edges[::-1], n_q - edges, n_q - edges, edges])
    e_r, e_q = (torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (e_r, e_q))
    e_valid = torch.ones(e_r.numel(), dtype=torch.bool, device=dev)
    for Wf in (W, W256):
        for wc in (False, True):
            args = (ref_w, q_w, e_r, e_q, e_valid, sub, 910, n_r, n_q)
            kw = dict(pad=pad, W=Wf, with_counts=wc)
            K.verify("first_scan_seq", f"B={e_r.numel()} W={Wf} counts="
                     f"{'on' if wc else 'off'} anchors within W of both "
                     f"ends of both sequences",
                     max(_state_err(g, w) for g, w in zip(
                         first_scan_seq(*args, **kw),
                         first_scan_seq_plain(*args, **kw))))

    Bc, tile = 16384, W
    for wc in (False, True):
        for left in (False, True):
            # the first window's survivors, then rows it finished
            st = first[wc][1 if left else 0]
            rows = torch.cat([torch.nonzero(~st["done"]).squeeze(1),
                              torch.nonzero(st["done"]).squeeze(1)])[:Bc]
            st = {k: v[rows] for k, v in st.items()}
            lr, lq = loc_r[rows], loc_q[rows]
            # rows at both sequence ends
            lr[:6] = torch.tensor([0, 1, 700, n_r - 1, n_r - 2, n_r - 900])
            lq[:6] = torch.tensor([n_q - 3, 2, 0, 5, n_q - 1, n_q - 600])
            # half the rows alive on entry, so that the check covers many
            # carried states, not only the first window's few survivors
            st["done"][:Bc // 2] = False
            off = -tile - Wc if left else tile
            r = gather_rows(ref_w, pad + lr + off, Wc)
            q = gather_rows(q_w, pad + lq + off, Wc)
            args = (r, q, lr, lq, st, sub, 910, tile, n_r, n_q)
            kw = dict(W=Wc, left=left, with_counts=wc)
            err = _state_err(window_scan(*args, **kw),
                             window_scan_plain(*args, **kw))
            K.check("window_scan",
                    f"B={Bc} W={Wc} tile={tile} "
                    f"{'left' if left else 'right'} "
                    f"counts={'on' if wc else 'off'} "
                    f"(alive on entry {int((~st['done']).sum())})", err,
                    lambda: window_scan(*args, **kw),
                    lambda: window_scan_plain(*args, **kw), 10,
                    *scan_work(lr, lq, ~st["done"], tile, left, wc, Wc))

    # K4 on the sequences (K4s): the continuation of both directions from
    # the states K1 on the sequences leaves
    def union_bytes(starts, ends):
        """The bytes the spans [start, end) cover, each once."""
        s0 = torch.cat(starts).cpu().numpy().astype(np.int64)
        e0 = torch.cat(ends).cpu().numpy().astype(np.int64)
        keep = e0 > s0
        order = np.argsort(s0[keep], kind="stable")
        s, e = s0[keep][order], e0[keep][order]
        if not len(s):
            return 0
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        ends_ = np.append(run_end[np.nonzero(new)[0][1:] - 1], run_end[-1])
        return int((ends_ - s[new]).sum())

    def continuation_work(seq_r, seq_q, calls, n_rows, n1, n2, wc,
                          xdrop=910):
        """(bytes, operations) of the continuation whose survivor steps are
        `calls` (k4s_rows.stepped's), from the plain walk of each step's
        windows: the in-bounds sequence bytes the windows cover, each once
        (one sequence given as both is read once), both directions' done
        flags, the alive rows' anchors and state in and out; six operations
        a lane up to a row's first drop in its last window, two past it."""
        spans = ([], [], [], [])
        lanes_all = torch.zeros((), dtype=torch.int64, device=dev)
        lanes_full = lanes_all.clone()
        alive = 0
        lanes = torch.arange(Wc, device=dev)
        for sr, sq, lrp, lqp, cst, t, left in calls:
            alive += lrp.numel()
            if left:
                n_inb = torch.minimum(lrp, lqp).long() - t
            else:
                n_inb = torch.minimum(n1 - lrp.long(), n2 - lqp.long()) - t
            n_inb = n_inb.clamp(0, Wc)
            r = gather_rows_plain(seq_r, sr, Wc)
            q = gather_rows_plain(seq_q, sq, Wc)
            if left:
                r, q = r.flip(1), q.flip(1)
            inb = lanes < n_inb[:, None]
            cum = torch.cumsum(torch.where(inb, sub[r.long() * 8 + q.long()],
                                           0), 1, dtype=torch.int32) \
                + cst["cum"][:, None]
            m = torch.maximum(torch.cummax(cum, 1).values,
                              cst["maxv"][:, None])
            d = torch.where(inb & (m - cum > xdrop), lanes, Wc).amin(1)
            lanes_all += n_inb.sum()
            lanes_full += torch.minimum(d + 1, n_inb).sum()
            for i, lc in enumerate((lrp, lqp)):
                # the window's in-bounds bytes: its first n_inb (right) or
                # last n_inb (left) storage bytes
                lo = (pad + lc.long() - t - n_inb if left
                      else pad + lc.long() + t)
                spans[2 * i].append(lo)
                spans[2 * i + 1].append(lo + n_inb)
        seq_bytes = (union_bytes(spans[0] + spans[2], spans[1] + spans[3])
                     if seq_r is seq_q else
                     union_bytes(spans[0], spans[1])
                     + union_bytes(spans[2], spans[3]))
        nbytes = (seq_bytes + 2 * n_rows + alive * (8 + 2 * STATE_BYTES)
                  + 256)
        lanes_all, lanes_full = int(lanes_all), int(lanes_full)
        extra = COUNT_OPS if wc else 0
        return nbytes, (lanes_full * (SCAN_OPS + extra)
                        + (lanes_all - lanes_full) * (SUM_OPS + extra))

    def check_k4s(seq_r, seq_q, lr, lq, ok, n1, n2, wc, label, variant,
                  reps):
        """K4s against window_scan_seq_plain from the states first_scan_seq
        leaves, timed beside the survivor steps' K2 + K4 launches (their
        calls kept by k4s_rows.stepped, replayed from a CUDA graph)."""
        states = first_scan_seq(seq_r, seq_q, lr, lq, ok, sub, 910, n1, n2,
                                pad=pad, W=W, with_counts=wc)
        kw = dict(pad=pad, tile=W, W=Wc, with_counts=wc)
        p = k4s_rows.Program((seq_r, seq_q, lr, lq, sub, 910, n1, n2),
                             *states, kw)
        alive = [int((~st["done"]).sum()) for st in states]
        want = window_scan_seq_plain(seq_r, seq_q, lr, lq,
                                     *({k: v.clone() for k, v in st.items()}
                                       for st in states), sub, 910, n1, n2,
                                     **kw)
        calls, steps = [], []
        k4s_rows.stepped(p, calls, steps)
        p.k4s()
        err = max(_state_err(g, w) for g, w in zip(p.states, want))
        if not all(bool(g["done"].all()) for g in p.states):
            fail(f"window_scan_seq {label}: a row is not done")
        nbytes, ops = continuation_work(seq_r, seq_q, calls, lr.numel(), n1,
                                        n2, wc)
        del want, states

        def kernel():
            p.restore()
            p.k4s()

        def plain():
            p.restore()
            window_scan_seq_plain(seq_r, seq_q, lr, lq, *p.states, sub, 910,
                                  n1, n2, **kw)

        full = f"B={lr.numel()} W={Wc} tile={W} {label} " \
               f"counts={'on' if wc else 'off'}"
        K.check("window_scan_seq",
                f"{full} (alive on entry: right {alive[0]}, left "
                f"{alive[1]}; {len(steps)} survivor steps)", err, kernel,
                plain, reps, nbytes, ops, reset=p.restore, variant=variant)
        replaced_ms = _graph_ms(
            lambda: [k4s_rows.step(p, c) for c in calls], reps)
        row = K.rows["window_scan_seq"]
        ms = (row if variant is None else row["variants"][variant])["ms"]
        rows_right = [n for left, n in steps if not left]
        rows_left = [n for left, n in steps if left]
        more = "..."
        print(f"  window_scan_seq {full}: kernel_ms {ms:.4f} against "
              f"{replaced_ms:.4f} for the {3 * len(steps)} K2 + K2 + K4 "
              f"launches of the survivor steps it took the place of (rows "
              f"a step: right {rows_right[:12]}"
              f"{more * (len(rows_right) > 12)}, left {rows_left[:12]}"
              f"{more * (len(rows_left) > 12)}) [{card}]", flush=True)
        row.setdefault("replaced_ms", {})[variant or full] = replaced_ms
        row.setdefault("steps", {})[variant or full] = dict(
            right=len(rows_right), left=len(rows_left),
            rows_right=sum(rows_right), rows_left=sum(rows_left))

    for wc in (False, True):
        check_k4s(ref_w, q_w, loc_r, loc_q, valid, n_r, n_q, wc, "hits",
                  None if not wc else "hits counts=on", 5)
    # rows that never drop: one random ACGT sequence of 256 kb as both
    # reference and query, each anchor the same on both, so every row walks
    # every window to both ends of the sequence
    n_s, B_s = 1 << 18, 4096
    rng_k = np.random.default_rng(2026)
    flat = torch.full((n_s + 2 * pad,), 6, dtype=torch.uint8, device=dev)
    flat[pad:pad + n_s] = torch.from_numpy(
        rng_k.integers(0, 4, n_s).astype(np.uint8)).to(dev)
    loc_f = torch.from_numpy(rng_k.integers(0, n_s, B_s).astype(
        np.int32)).to(dev)
    for wc in (False, True):
        label = f"never drop counts={'on' if wc else 'off'}"
        check_k4s(flat, flat, loc_f, loc_f,
                  torch.ones(B_s, dtype=torch.bool, device=dev), n_s, n_s,
                  wc, "never drop", label, 3)
    del flat

    def check_wide(lr, lq, st, tile, left, wc, label, reps):
        """K5 on the route's windows: a gather, flipped to the left."""
        off = -tile - Wc if left else tile
        r = gather_rows(ref_w, pad + lr + off, Wc)
        q = gather_rows(q_w, pad + lq + off, Wc)
        if left:
            r, q = r.flip(1), q.flip(1)
        args = (r, q, lr, lq, st, sub, 910, tile, n_r, n_q)
        kw = dict(W=Wc, left=left, with_counts=wc)
        got = window_scan_wide(*args, **kw)
        err = _state_err(got, window_scan_wide_plain(*args, **kw))
        K.check("window_scan_wide",
                f"B={lr.numel()} W={Wc} tile={tile} "
                f"{'left' if left else 'right'} "
                f"counts={'on' if wc else 'off'} {label} (alive after "
                f"{int((~got['done']).sum())})", err,
                lambda: window_scan_wide(*args, **kw),
                lambda: window_scan_wide_plain(*args, **kw), reps,
                *scan_work(lr, lq, ~st["done"], tile, left, wc, Wc))
        return got

    # counts on first: the device route scans with them, and a kernel's
    # first check gives its row
    for wc in (True, False):
        for left in (False, True):
            # the route's first window: every hit, fresh state
            st = check_wide(loc_r, loc_q,
                            init_state(B, 0 if left else -1, valid, dev), 0,
                            left, wc, "fresh", 3)
            # its survivors first, then rows it finished, carried on
            rows = torch.cat([torch.nonzero(~st["done"]).squeeze(1),
                              torch.nonzero(st["done"]).squeeze(1)])[:Bc]
            st = {k: v[rows] for k, v in st.items()}
            lr, lq = loc_r[rows], loc_q[rows]
            lr[:6] = torch.tensor([0, 1, 700, n_r - 1, n_r - 2, n_r - 900])
            lq[:6] = torch.tensor([n_q - 3, 2, 0, 5, n_q - 1, n_q - 600])
            st["done"][:Bc // 2] = False
            check_wide(lr, lq, st, Wc, left, wc,
                       f"carried (alive on entry "
                       f"{int((~st['done']).sum())})", 10)
    # the device route's engine on its first hit range (these 2^17 hits,
    # every row valid; on the route the rows outside an RM window are not
    # valid), counts on: K1s, then K4s, each checked and timed at these
    # shapes; the two held field for field to the stepped engine they took
    # the place of (extend_hits_stepped: K2, K2 and K5 a step and
    # direction, W = 2048 from tile 0), and timed beside that engine's
    # launches on the same rows (each step recorded, then replayed from a
    # CUDA graph)
    seq_bytes = sum(covered_bytes(pad + lc - W, 2 * W, pad, pad + n)
                    for lc, n in ((loc_r, n_r), (loc_q, n_q)))
    args = (ref_w, q_w, loc_r, loc_q, all_valid, sub, 910, n_r, n_q)
    kw = dict(pad=pad, W=W, with_counts=True)
    err = max(_state_err(g, w) for g, w in zip(
        first_scan_seq(*args, **kw), first_scan_seq_plain(*args, **kw)))
    K.check("first_scan_seq", f"B={B} W={W} counts=on, the device route's "
            f"first hit range", err, lambda: first_scan_seq(*args, **kw),
            lambda: first_scan_seq_plain(*args, **kw), 5,
            seq_bytes + B * (9 + 2 * STATE_BYTES),
            sum(scan_work(loc_r, loc_q, all_valid, 0, left, True, W,
                          full_lanes[W][left])[1] for left in (False, True)),
            variant="device route W=512 counts=on")
    check_k4s(ref_w, q_w, loc_r, loc_q, all_valid, n_r, n_q, True,
              "the device route's first hit range", "device route counts=on",
              5)

    def wide_step(call):
        """One step of the stepped engine: K2, K2 and K5."""
        sr, sq, lrp, lqp, cst, t, left = call
        r, q = gather_rows(ref_w, sr, Wc), gather_rows(q_w, sq, Wc)
        if left:
            r, q = r.flip(1), q.flip(1)
        return window_scan_wide(r, q, lrp, lqp, cst, sub, 910, t, n_r, n_q,
                                W=Wc, left=left, with_counts=True)

    # the stepped engine's steps on these rows: the right direction from
    # zero counts, then the left one from the right direction's
    steps, counts = [], None
    for left in (False, True):
        st = init_state(B, 0 if left else -1, all_valid, dev)
        if left:
            st["counts"] = counts.clone()
        idx, t = torch.nonzero(~st["done"]).squeeze(1), 0
        while idx.numel():
            off = -t - Wc if left else t
            cst = {k: st[k][idx] for k in STATE_KEYS}
            steps.append((pad + loc_r[idx] + off, pad + loc_q[idx] + off,
                          loc_r[idx], loc_q[idx], cst, t, left))
            new = wide_step(steps[-1])
            for k in STATE_KEYS:
                st[k][idx] = new[k]
            idx, t = idx[~new["done"]], t + Wc
        counts = st["counts"]
    eng = (ref_w, q_w, loc_r, loc_q, all_valid, sub, 910, 3000, n_r, n_q)
    err = _state_err(extend_hits_windowed(*eng, pad=pad, W=W, W_CONT=Wc),
                     extend_hits_stepped(*eng, pad=pad, W=pad))
    if err:
        fail(f"the device route's engine (K1s, K4s) differs from the "
             f"stepped engine (K2, K5) on its first hit range "
             f"(max_abs_err {err})")

    def engine():
        st = first_scan_seq(*args, **kw)
        window_scan_seq(ref_w, q_w, loc_r, loc_q, *st, sub, 910, n_r, n_q,
                        pad=pad, tile=W, W=Wc, with_counts=True)

    engine_ms = _graph_ms(engine, 3)
    replaced_ms = _graph_ms(lambda: [wide_step(c) for c in steps], 3)
    rows_a_step = [c[2].numel() for c in steps]
    print(f"  the device route's engine B={B}, counts on: K1s + K4s "
          f"kernel_ms {engine_ms:.4f} (2 launches) against {replaced_ms:.4f} "
          f"for the {3 * len(steps)} K2 + K2 + K5 launches of the stepped "
          f"engine's {len(steps)} steps on the same rows (rows a step "
          f"{rows_a_step}); the fields of the two engines equal "
          f"(max_abs_err 0) [{card}]", flush=True)
    K.rows["first_scan_seq"]["device_route"] = dict(
        ms=engine_ms, replaced_ms=replaced_ms, steps=len(steps),
        replaced_launches=3 * len(steps), rows_a_step=rows_a_step)
    del steps, st, new, counts
    del ref_w, q_w, first
    torch.cuda.empty_cache()

    # S1 and S2 at exp_gather_variants' shapes, S3/S4 at the probes'
    seq_r, seq_q, st, st2 = exp_gather_variants.make_inputs(dev)
    Wv, Bv = exp_gather_variants.W, exp_gather_variants.B
    for name in ("gather_dma_only", "gather_extract_only", "gather_dbuf"):
        fn, plain = getattr(gv, name), getattr(gv, name + "_plain")
        err = _err(fn(seq_r, st, Wv), plain(seq_r, st, Wv))
        # load only and double-buffered gather like K2; extract only
        # reads the starts alone and writes zeros, which one torch.zeros
        # does too
        nbytes = (4 * Bv + Bv * Wv if name == "gather_extract_only"
                  else gather_bytes(seq_r, Bv, Wv))
        K.check(name, f"B={Bv} W={Wv}", err, lambda: fn(seq_r, st, Wv),
                lambda: plain(seq_r, st, Wv), 20, nbytes,
                library=(lambda: torch.zeros(
                    (Bv, Wv), dtype=torch.uint8, device=dev))
                if name == "gather_extract_only"
                else lambda: index_gather(seq_r, st, Wv))
        # starts at every offset kind of a 1024-byte slice, and at both
        # ends of the range the wrapper admits
        hi_v = seq_r.numel() - gv.awin_for(Wv)
        edge = torch.tensor(
            [0, hi_v] + [k * 1024 + o for k in (0, 3, 700)
                         for o in (0, 1, 15, 16, 1023)]
            + [hi_v - 1, hi_v - 15, hi_v - 16] * 50, dtype=torch.int32,
            device=dev)
        K.verify(name, f"B={edge.numel()} W={Wv} offsets 0, 1, 15, 16, 1023 "
                 f"of a slice, both ends of [0, {hi_v}]",
                 _err(fn(seq_r, edge, Wv), plain(seq_r, edge, Wv)))
    # both sides as one index call: the sequences end to end
    seq_both = torch.cat([seq_r, seq_q])
    idx_both = st2.long()
    idx_both[Bv:] += seq_r.numel()
    err = max(_err(g, w) for g, w in zip(
        gv.gather_two_sided(seq_r, seq_q, st2, Wv),
        gv.gather_two_sided_plain(seq_r, seq_q, st2, Wv)))
    K.check("gather_two_sided", f"B={Bv} x 2 sides W={Wv}", err,
            lambda: gv.gather_two_sided(seq_r, seq_q, st2, Wv),
            lambda: gv.gather_two_sided_plain(seq_r, seq_q, st2, Wv), 20,
            gather_bytes(seq_r, Bv, Wv, sides=2),
            library=lambda: index_gather(seq_both, idx_both, Wv))
    for shape, label in (((256, 512), "S3"), ((8, 128), "S4")):
        x = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
        K.check("scale2", f"{shape} float32 ({label})",
                _err(scale2(x), scale2_plain(x)), lambda: scale2(x),
                lambda: scale2_plain(x), 50, 8 * x.numel(), x.numel(),
                library=lambda: x * 2)
    del seq_r, seq_q, st, st2, seq_both, idx_both

    # ---- phase 2: the slice at full size
    print("phase 2: DeviceAligner.map_chunks over the repeat-1x pair",
          flush=True)
    work = bench_inputs.chunk_work(query)
    wrappers = dict(gather_rows=gather_rows,
                    gather_rows_tile=gather_rows_tile,
                    first_scan=first_scan, first_scan_seq=first_scan_seq,
                    window_scan=window_scan,
                    window_scan_seq=window_scan_seq,
                    window_scan_wide=window_scan_wide)
    # the native route's kernels, and those it no longer launches (every
    # window comes from the sequences, not from gathered rows)
    native_k = ("first_scan_seq", "window_scan_seq")
    off_path = ("first_scan", "gather_rows", "gather_rows_tile",
                "window_scan", "window_scan_wide")

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        gather_rows_tile.launches_by_T = {}

    by_T = {}   # K3's launches of each slice, split by T
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    results = al.map_chunks(work, depth=bench_inputs.DEPTH)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    by_slice = {"native_pair": dict(launches)}
    by_T["native_pair"] = dict(gather_rows_tile.launches_by_T)
    n_hsps = sum(len(r.hsps) for r in results)
    n_hits = sum(r.num_hits for r in results)
    n_seeds = sum(r.num_seeds for r in results)
    for r in results:
        if r.hsps.ndim != 2 or r.hsps.shape[1] != 4 or r.hsps.dtype != \
                np.int64:
            fail(f"malformed HSP array {r.hsps.shape} {r.hsps.dtype}")
        if len(r.hsps) and (r.hsps[:, 2].min() < 0
                            or r.hsps[:, 3].min() < 3000):
            fail("an HSP has a negative length or a score below 3000")
    print(f"slice: {len(work)} chunk-strands, {n_hits} hits "
          f"({n_hits / (len(query) / 1e6):.3g} per Mbp), {n_hsps} HSPs, "
          f"wall {dt:.3f} s, {len(query) / 1e6 / dt:.3f} Mbp/s, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
          f"launches {launches}, gather_rows_tile by T "
          f"{by_T['native_pair']} [{card}]", flush=True)
    if n_hsps != EXPECTED_HSPS:
        fail(f"{n_hsps} HSPs, expected {EXPECTED_HSPS}")
    for k in native_k:
        if launches[k] == 0:
            fail(f"{k} was not launched on the main path")
    for k in off_path:
        if launches[k] != 0:
            fail(f"{k} was launched {launches[k]} times on the main path, "
                 f"which reads every window from the sequences")
    # one K1s and one K4s launch a program: a replay of the program's
    # graph counts both (a chunk-strand extended again runs its programs
    # twice)
    programs = sum(-(-r.num_hits // al.HBUF) * (1 + r.reextended)
                   for r in results)
    if not (launches["window_scan_seq"] == launches["first_scan_seq"]
            == programs):
        fail(f"window_scan_seq launched {launches['window_scan_seq']} "
             f"times, first_scan_seq {launches['first_scan_seq']}: not "
             f"once a program each ({programs} programs)")

    def same_results(got, want, label):
        for w, a, b in zip(work, got, want):
            if (a.num_hits, a.num_seeds) != (b.num_hits, b.num_seeds) or \
                    not np.array_equal(a.hsps, b.hsps):
                fail(f"{label} on chunk {w.chunk_start}:{w.chunk_end} "
                     f"rev={w.rev}")
        n = sum(len(r.hsps) for r in got)
        if n != EXPECTED_HSPS:
            fail(f"{label}: {n} HSPs, expected {EXPECTED_HSPS}")

    def timed(aligner, **kw):
        """(results, seconds, what it wrote to stderr) of one map_chunks."""
        err = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stderr(err):
            out = aligner.map_chunks(work, **kw)
        torch.cuda.synchronize()
        sys.stderr.write(err.getvalue())
        return out, time.time() - t0, err.getvalue()

    # the serial form against the default, which finishes each chunk on a
    # thread of its own while this thread seeds and extends the next
    with _env(SEGALIGN_OVERLAP="0"):
        results_s, dt_s, _ = timed(al, depth=bench_inputs.DEPTH)
    same_results(results_s, results, "the serial map_chunks differs from "
                 "the default form's")
    results_s, dt_a, _ = timed(al, depth=bench_inputs.DEPTH)
    same_results(results_s, results, "the default form's second run "
                 "differs from its first")
    del results_s
    print(f"finisher thread: every chunk-strand equal to the serial form's; "
          f"wall serial {dt_s:.3f} s, with the finisher thread {dt_a:.3f} s "
          f"({dt:.3f} s in the first run) [{card}]", flush=True)
    results_s, said = check_program_graphs(al, work, _env, card)
    same_results(results_s, results, "the pass under the sync check "
                 "differs from the first run")
    del results_s
    print(said, flush=True)
    print(f"re-extended chunk-strands in the first run: "
          f"{sum(r.reextended for r in results)} [{card}]", flush=True)

    # ---- phase 2c: the farm, two aligners on the one card
    print("phase 2c: MultiDeviceAligner(device='cuda:0', num_devices=2)"
          ".map_chunks over the repeat-1x pair", flush=True)
    host_tables = al._host_tables
    shared_kw = {k: v for k, v in settings.items() if k != "device"}
    farm = MultiDeviceAligner(device="cuda:0", num_devices=2, **shared_kw)
    farm.set_ref(ref, tables=host_tables)
    farm.set_query(query, qrc)

    def farm_ran_whole(label):
        """Both workers lived: a failure that the requeue absorbed changes
        no result, so it must show here."""
        if farm.errors or farm.dead:
            fail(f"{label}: aligner(s) {sorted(farm.dead)} of the farm "
                 f"failed, and no failure was injected: {farm.errors!r}")
        if min(farm.chunks_by) == 0 or sum(farm.chunks_by) != len(work):
            fail(f"{label}: chunks by aligner {farm.chunks_by} of "
                 f"{len(work)}: an aligner did none")

    reset_counts()
    results_f, dt_f1, said = timed(farm, depth=bench_inputs.DEPTH)
    farm_ran_whole("the farm's first run")
    chunks_by = list(farm.chunks_by)
    launches_f = {k: w.launches for k, w in wrappers.items()}
    by_slice["farm_pair"] = launches_f
    by_T["farm_pair"] = dict(gather_rows_tile.launches_by_T)
    same_results(results_f, results, "the farm differs from one aligner")
    _, dt_o1, _ = timed(al, depth=bench_inputs.DEPTH)
    _, dt_o2, _ = timed(al, depth=bench_inputs.DEPTH)
    results_f, dt_f2, said2 = timed(farm, depth=bench_inputs.DEPTH)
    farm_ran_whole("the farm's second run")
    same_results(results_f, results, "the farm's second run differs from "
                 "one aligner")
    if "after device failure" in said + said2:
        fail("the farm retried chunks, and no failure was injected")
    print(f"farm: {EXPECTED_HSPS} HSPs, every chunk-strand equal to one "
          f"aligner's; no worker failed, chunks by aligner {chunks_by} and "
          f"{farm.chunks_by}; wall farm {dt_f1:.3f} and {dt_f2:.3f} s, one aligner "
          f"{dt:.3f} (phase 2, first run), {dt_o1:.3f} and {dt_o2:.3f} s; "
          f"launches {launches_f} [{card}]", flush=True)
    for k in native_k:
        if launches_f[k] == 0:
            fail(f"{k} was not launched by the farm")
    # the same chunks launch the same kernels whichever aligner takes them,
    # and the wrappers count under one lock
    if launches_f != launches or by_T["farm_pair"] != by_T["native_pair"]:
        fail(f"the farm's launches {launches_f} (K3 by T "
             f"{by_T['farm_pair']}) are not one aligner's {launches} "
             f"({by_T['native_pair']}) on the same chunks")
    del farm, results_f

    # ---- phase 2b: the device-seeding route on the same slice
    print("phase 2b: DeviceAligner(device_seeding=True).map_chunks over "
          "the repeat-1x pair", flush=True)
    t0 = time.time()
    al_d = DeviceAligner(**settings, device_seeding=True)
    al_d.set_ref(ref, tables=al._host_tables)
    al_d.set_query(query, qrc)
    print(f"device route set-up (tables and queries to the card) "
          f"{time.time() - t0:.1f} s", flush=True)
    del al
    torch.cuda.empty_cache()
    reset_counts()
    device_mod.reset_stage_totals()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    results_d = al_d.map_chunks(work)
    torch.cuda.synchronize()
    dt_d = time.time() - t0
    launches_d = {k: w.launches for k, w in wrappers.items()}
    ranges_d = nranges()
    by_slice["device_pair"] = launches_d
    by_T["device_pair"] = dict(gather_rows_tile.launches_by_T)
    n_d = sum(len(r.hsps) for r in results_d)
    print(f"device route: {n_d} HSPs, wall {dt_d:.3f} s, "
          f"{len(query) / 1e6 / dt_d:.3f} Mbp/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
          f"{ranges_d} hit ranges, launches {launches_d} [{card}]",
          flush=True)
    same_results(results_d, results,
                 "the device route differs from the native route")
    bad = engine_faults(launches_d, ranges_d) + [
        f"{k} launched" for k in off_path if launches_d[k]]
    if bad:
        fail(f"the device route's launches {launches_d}: {bad}")
    mem_d = torch.cuda.max_memory_allocated(dev)
    del al_d, results
    torch.cuda.empty_cache()

    # ---- phase 2d: the sharded seed table, four shards on the one card
    print("phase 2d: ShardedAligner(device='cuda:0', num_devices=4)"
          ".map_chunks over the repeat-1x pair", flush=True)
    t0 = time.time()
    shd = ShardedAligner(device="cuda:0", num_devices=4, **shared_kw)
    shd.set_ref(ref, tables=host_tables)
    shd.set_query(query, qrc)
    print(f"sharded set-up (table slices and sequences to the card) "
          f"{time.time() - t0:.1f} s", flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    results_s, dt_s, _ = timed(shd)
    launches_s = {k: w.launches for k, w in wrappers.items()}
    by_slice["sharded_pair"] = launches_s
    by_T["sharded_pair"] = dict(gather_rows_tile.launches_by_T)
    same_results(results_s, results_d,
                 "the sharded table differs from the device route")
    print(f"sharded table, 4 shards: {EXPECTED_HSPS} HSPs, every "
          f"chunk-strand's HSPs, hits and seeds equal to the device "
          f"route's; wall {dt_s:.3f} s (device route {dt_d:.3f} s), "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (device "
          f"route {mem_d / 2**30:.2f} GiB), launches {launches_s} "
          f"(device route {launches_d}) [{card}]", flush=True)
    if engine_faults(launches_s):
        fail(f"the sharded aligner: {engine_faults(launches_s)}")
    del shd, results_s
    torch.cuda.empty_cache()

    # ---- phase 2e: the sharded table across two processes on the one card
    print("phase 2e: ShardedAligner(group=...) across two processes x two "
          "shards on cuda:0", flush=True)
    t0 = time.time()
    outs = run_workers(
        dict(mode="sharded", ref=ref, query=query, shards=2, runs=2,
             kw=shared_kw, work=[(w.chunk_start, w.chunk_end, w.rev,
                                  w.window) for w in work]),
        2, "cuda:0", os.path.join(ROOT, "build", "chip_smoke_2e"))
    dt_e = time.time() - t0
    for o in outs:
        same_results([ChunkResult(*t) for t in o["results"]], results_d,
                     f"rank {o['rank']} of the sharded table across two "
                     f"processes differs from the device route")
        by_slice[f"sharded_2proc_rank{o['rank']}"] = o["launches"]
        if engine_faults(o["launches"]):
            fail(f"rank {o['rank']} of two: "
                 f"{engine_faults(o['launches'])}")
    o0 = outs[0]
    print(f"sharded table, 2 processes x 2 shards ({o0['backend']}"
          f"{', through host memory' if o0['host_staged'] else ''}; S = "
          f"{o0['shards']}): every rank's {EXPECTED_HSPS} HSPs, hits and "
          f"seeds equal to the device route's; walls (cold, warm) "
          f"{[[round(w, 3) for w in o['walls']] for o in outs]} s (4 shards "
          f"in one process {dt_s:.3f} s), collectives "
          f"{[round(o['comm'][0], 3) for o in outs]} s of a third run's "
          f"{[round(o['comm'][1], 3) for o in outs]} s (by function "
          f"{[{k: round(v, 3) for k, v in o['comm'][2].items()}
              for o in outs]}), start-up "
          f"{[round(o['t_init'], 3) for o in outs]} s, set-up "
          f"{[round(o['t_setup'], 3) for o in outs]} s, max_memory_allocated "
          f"{[round(o['peak_bytes'] / 2**30, 2) for o in outs]} GiB a "
          f"process (4 shards in one process: see phase 2d), launches "
          f"{[o['launches'] for o in outs]}; spawn to join {dt_e:.1f} s "
          f"[{card}]", flush=True)
    del outs, results_d

    # ---- phase 3: the CLI
    # ---- phases 3, 3b and 3d: the CLIs, ten processes at once
    print("phases 3, 3b, 3d: the CLI on a fixed FASTA pair, the RM CLI on a "
          "fixed FASTA on both seeding routes, the CLIs with two devices, "
          "the sharded table, two hosts and the native gapped stage; ten "
          "processes at once", flush=True)
    d = os.path.join(ROOT, "build", "chip_smoke_cli")
    os.makedirs(d, exist_ok=True)
    write_cli_pair(d)
    write_rm_genome(d)
    pair = [os.path.join(d, "ref.fa"), os.path.join(d, "query.fa")]
    rm_in = [os.path.join(d, "seq.fa"), "--markend"]
    one_card = ["--num_devices", "2", "--device", "cuda:0"]
    # five intervals, so that each of two hosts has some
    split = [*pair, "--nogapped", "--lastz_interval_size", "30000"]
    pw, rm = "run_segalign", "run_segalign_repeat_masker"
    want = {"cli": CLI_SHA256,
            "rm cli (native route)": RM_CLI_SHA256,
            "rm cli (device route)": RM_CLI_SHA256,
            "cli, two aligners on cuda:0": CLI_SHA256,
            "cli, sharded table, two shards on cuda:0": CLI_SHA256,
            "rm cli, sharded table, two shards on cuda:0": RM_CLI_SHA256,
            "cli, one host": None, "cli, host 0 of 2": None,
            "cli, host 1 of 2": None,
            "cli, native gapped stage, maf-": GAPPED_CLI_SHA256}
    args = [(pw, [*pair, "--nogapped", "--markend"], {}),
            (rm, rm_in, {}),
            (rm, rm_in, {"SEGALIGN_DEVICE_SEEDING": "1"}),
            (pw, [*pair, "--nogapped", "--markend", *one_card], {}),
            (pw, [*pair, "--nogapped", "--markend", "--sharded_table",
                  *one_card], {}),
            (rm, [*rm_in, "--sharded_table", *one_card], {}),
            (pw, split, {}),
            (pw, [*split, "--num_hosts", "2", "--host_id", "0"], {}),
            (pw, [*split, "--num_hosts", "2", "--host_id", "1"], {}),
            (pw, [*pair, "--gapped_mode", "native", "--format", "maf-"], {})]
    t0 = time.time()
    clis = run_clis([(label, *a) for label, a in zip(want, args)], d)
    for label, (data, digest, secs, launched) in clis.items():
        what = (f"{data.count(b'\n') - 2} intervals"   # less header, mark
                if label.startswith("rm") else
                f"{data.count(b'\n')} lines")
        print(f"{label}: {what}, exited after {secs:.1f} s, sha256 "
              f"{digest}, launches {launched}", flush=True)
        if want[label] is not None and digest != want[label]:
            fail(f"{label}: output sha256 {digest} != {want[label]}")
        if engine_faults(launched):
            fail(f"{label}: {engine_faults(launched)}")
    print(f"ten CLI processes: {time.time() - t0:.1f} s", flush=True)
    single = clis["cli, one host"][0].splitlines()
    hosts = [clis[f"cli, host {h} of 2"][0].splitlines() for h in (0, 1)]
    if not hosts[0] or not hosts[1] or set(hosts[0]) & set(hosts[1]):
        fail(f"two hosts: {len(hosts[0])} and {len(hosts[1])} lines, "
             f"{len(set(hosts[0]) & set(hosts[1]))} in both")
    if sorted(hosts[0] + hosts[1]) != sorted(single):
        fail("two hosts' lines together are not the one-host run's")
    print(f"two hosts: {len(hosts[0])} + {len(hosts[1])} disjoint lines, "
          f"together the one-host run's {len(single)}", flush=True)

    # ---- phase 3c: the repeat masker at real size, both routes
    print("phase 3c: run_repeat_masker on the repeat-1x reference",
          flush=True)
    genome = ref[:RM_REAL_LEN]
    if len(genome) < len(ref):
        print(f"genome cut to {len(genome)} of {len(ref)} bases", flush=True)
    fa = os.path.join(d, "rm_ref.fa")
    bench_inputs.write_codes_fasta(fa, genome)
    cfg = RMConfig(seq_filename=fa)
    got = {}
    for route in ("native", "device"):
        out_dir = os.path.join(d, f"rm_{route}")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        reset_counts()
        device_mod.reset_stage_totals()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        st = run_repeat_masker(cfg, out_dir, device=dev,
                               device_seeding=route == "device")
        torch.cuda.synchronize()
        dt_rm = time.time() - t0
        files = {}
        for f in sorted(os.listdir(out_dir)):
            if f != "MANIFEST.jsonl":
                with open(os.path.join(out_dir, f), "rb") as fh:
                    files[f] = fh.read()
        got[route] = files
        by_slice[f"rm_{route}"] = {k: w.launches
                                   for k, w in wrappers.items()}
        by_T[f"rm_{route}"] = dict(gather_rows_tile.launches_by_T)
        n_iv = sum(v.count(b"\n") for v in files.values())
        print(f"rm {route} route: {len(genome) / 1e6:.1f} Mbp, {n_iv} "
              f"intervals, {st.num_seed_hits} hits, {st.num_hsps} HSPs, "
              f"wall {dt_rm:.3f} s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
              f"launches {by_slice[f'rm_{route}']}, gather_rows_tile by T "
              f"{by_T[f'rm_{route}']}"
              + (f", {nranges()} hit ranges" if route == "device" else "")
              + f" [{card}]", flush=True)
        if n_iv == 0:
            fail(f"rm {route} route wrote no intervals")
        if route == "device" and engine_faults(by_slice["rm_device"],
                                               nranges()):
            fail(f"rm device route: "
                 f"{engine_faults(by_slice['rm_device'], nranges())}")
    if got["native"] != got["device"]:
        fail("the repeat masker's interval files differ between routes")

    # ---- phase 3e: the CLIs at genome scale, one process at a time
    print("phase 3e: the CLI on scale-8 (8 x 8 Mbp, 8 and 5 records) and "
          "the RM CLI on scale-4's reference (4 Mbp, 8 records) against the "
          "JAX CLIs, both on scale-16 (16 x 16 Mbp, 16 and 10 records) over "
          "every route", flush=True)
    t3e = time.time()
    d = os.path.join(ROOT, "build", "chip_smoke_scale")
    os.makedirs(d, exist_ok=True)
    fa, codes = {}, {}
    for tag in ("4", "8", "16"):
        fa[tag] = (os.path.join(d, f"ref{tag}.fa"),
                   os.path.join(d, f"qry{tag}.fa"))
        codes[tag] = bench_inputs.write_scale_inputs(f"scale-{tag}",
                                                     *fa[tag])
    digests = [sha256_file(f) for f in (*fa["8"], fa["4"][0])]
    want_in = [SCALE8_REF_SHA256, SCALE8_QUERY_SHA256, SCALE4_REF_SHA256]
    print(f"scale inputs written in {time.time() - t3e:.1f} s; FASTA "
          f"sha256 {digests[0]} (scale-8 ref), {digests[1]} (scale-8 "
          f"query), {digests[2]} (scale-4 ref)", flush=True)
    if digests != want_in:
        fail(f"the scale FASTAs hash to {digests}, not to the inputs of the "
             f"JAX goldens {want_in}")
    nog = ["--nogapped", "--markend"]
    on0 = ["--device", "cuda:0"]
    dev_env = {"SEGALIGN_DEVICE_SEEDING": "1"}
    # label: (module, argv, env); every route launches K1s and K4s and
    # neither K2 nor K5
    scale_jobs = {
        "scale-8 cli": (pw, [*fa["8"], *nog], {}),
        "scale-16 cli (native route)": (pw, [*fa["16"], *nog], {}),
        "scale-16 cli (device route)": (pw, [*fa["16"], *nog], dev_env),
        "scale-16 cli, two aligners on cuda:0": (
            pw, [*fa["16"], *nog, *on0, "--num_devices", "2"], {}),
        "scale-16 cli, sharded table, four shards on cuda:0": (
            pw, [*fa["16"], *nog, "--sharded_table", *on0, "--num_devices",
                 "4"], {}),
        "scale-4 rm cli": (rm, [fa["4"][0], "--markend"], {}),
        "scale-16 rm cli (native route)": (rm, [fa["16"][0], "--markend"],
                                           {}),
        "scale-16 rm cli (device route)": (rm, [fa["16"][0], "--markend"],
                                           dev_env),
    }
    scale = {}
    for i, (label, (module, argv, env)) in enumerate(scale_jobs.items()):
        r = run_cli_logged(label, module, argv, env,
                           os.path.join(d, f"cli_{i}"))
        scale[label] = r
        st = r["stats"]
        print(scale_line(label, r, module == rm, card), flush=True)
        by_slice[label] = st["launches"]
        if engine_faults(st["launches"]):
            fail(f"{label}: {engine_faults(st['launches'])}")
    for label, want, n_want in (
            ("scale-8 cli", SCALE8_CLI_SHA256, SCALE8_HSPS),
            ("scale-4 rm cli", SCALE4_RM_SHA256, SCALE4_INTERVALS)):
        r = scale[label]
        n = r["data"].count(b"\n") - (2 if "rm" in label else 1)
        if r["sha256"] != want or n != n_want:
            fail(f"{label}: sha256 {r['sha256']} and {n} lines, the JAX "
                 f"CLI's {want} and {n_want}")
    for prefix in ("scale-16 cli", "scale-16 rm cli"):
        outs = {k: v["sha256"] for k, v in scale.items()
                if k.startswith(prefix)}
        if len(set(outs.values())) != 1:
            fail(f"{prefix}: the routes' outputs differ: {outs}")
    n16 = scale["scale-16 cli (native route)"]["stats"]["hsps"]
    if n16 == 0:
        fail("scale-16: no HSPs")
    # the engine (K1s, K4s) on a sample of scale-16's hit ranges against
    # the stepped check engine (K2 gathers and K5 steps at W = 2048), field
    # for field: every hit range of every eighth chunk-strand and of the
    # last (the last chunk's reverse strand), on scale-16's pair taken as
    # one block (its records end to end) by a device route aligner in this
    # process
    t0 = time.time()
    al16 = DeviceAligner(**settings, device_seeding=True)
    ref16, q16 = codes["16"]
    al16.set_ref(ref16)
    al16.set_query(q16, revcomp_codes(q16))
    work16 = bench_inputs.chunk_work(q16)
    sample = work16[::8] + work16[-1:]
    n_ranges = n_cand = 0
    for w in sample:
        s16 = al16._seed_chunk(w.chunk_start, w.chunk_end, w.rev, None)
        for batch in _hit_ranges(s16.seg_ends.tolist(), al16.HBUF):
            for g0, g1 in batch:
                eng = (al16.ref_pad, al16.q_rc if w.rev else al16.q_fw,
                       *_range_hits(al16.pos_table, s16.cum, s16.starts,
                                    s16.qpos, g0, g1, al16.seed_size,
                                    None),
                       al16.sub, al16.xdrop, al16.hspthresh, al16.ref_len,
                       al16.q_len)
                got16 = extend_hits_windowed(*eng, pad=PAD, W=al16.window,
                                             W_CONT=CONT_W)
                err = _state_err(got16, extend_hits_stepped(*eng, pad=PAD,
                                                            W=PAD))
                if err:
                    fail(f"scale-16 chunk {w.chunk_start} rev={w.rev} hits "
                         f"[{g0}, {g1}): the engine differs from the "
                         f"stepped engine (max_abs_err {err})")
                n_ranges += 1
                n_cand += int(got16["candidate"].sum())
    if n_cand == 0:
        fail(f"scale-16: no candidate in the {n_ranges} sampled hit ranges")
    print(f"scale-16: the engine equals the stepped engine (K2, K5) field "
          f"for field on all {n_ranges} hit ranges of {len(sample)} "
          f"chunk-strands ({n_cand} candidates); {time.time() - t0:.1f} s "
          f"[{card}]", flush=True)
    del al16, codes, ref16, q16, eng, got16
    torch.cuda.empty_cache()
    print(f"scale-8 and scale-4: the CLIs hash to the JAX CLIs'; scale-16: "
          f"the four routes' {n16} HSPs byte-identical, the RM's two routes "
          f"identical; phase 3e {time.time() - t3e:.1f} s [{card}]",
          flush=True)

    # ---- phase 3f: past one hit batch and one target block
    print("phase 3f: the CLIs over several target blocks and logical hit "
          "batches: scale-8 and scale-4's reference against the JAX CLIs "
          "on every route, block-1000 (two 500 Mbp target blocks)",
          flush=True)
    t3f = time.time()
    split = ["--max_hits", str(SPLIT_MAX_HITS)]
    pw_split = [*fa["8"], *nog, "--seq_block_size", "2000000", *split]
    rm_split = [fa["4"][0], "--markend", "--seq_block_size", "1000000",
                *split]
    # label: (module, argv, env), as in phase 3e; all at once
    split_jobs = {
        "scale-8 split (native route)": (pw, pw_split, {}),
        "scale-8 split (device route)": (pw, pw_split, dev_env),
        "scale-8 split, two aligners on cuda:0": (
            pw, [*pw_split, *on0, "--num_devices", "2"], {}),
        "scale-8 split, sharded table, four shards on cuda:0": (
            pw, [*pw_split, "--sharded_table", *on0, "--num_devices", "4"],
            {}),
        "scale-4 rm split (native route)": (rm, rm_split, {}),
        "scale-4 rm split (device route)": (rm, rm_split, dev_env),
        "scale-4 rm split, sharded table, two shards on cuda:0": (
            rm, [*rm_split, "--sharded_table", *on0, "--num_devices", "2"],
            {}),
    }
    got = run_clis_logged([
        (label, module, argv, env, os.path.join(d, f"split_{i}"))
        for i, (label, (module, argv, env)) in enumerate(
            split_jobs.items())])
    for label, (module, _, _) in split_jobs.items():
        r = got[label]
        st = r["stats"]
        print(scale_line(label, r, module == rm, card), flush=True)
        by_slice[label] = st["launches"]
        if engine_faults(st["launches"]):
            fail(f"{label}: {engine_faults(st['launches'])}")
        # the RM's 1 Mbp blocks of a 4 Mbp genome of 8 records (and its
        # separators) make 5, the pair's 2 Mbp blocks of 1 Mbp records 4
        want, n_want, blocks = (
            (SCALE4_RM_SPLIT_SHA256, SCALE4_RM_SPLIT_INTERVALS, 5)
            if module == rm else
            (SCALE8_SPLIT_SHA256, SCALE8_SPLIT_HSPS, 4))
        n = r["data"].count(b"\n") - (2 if module == rm else 1)
        if r["sha256"] != want or n != n_want:
            fail(f"{label}: sha256 {r['sha256']} and {n} lines, the JAX "
                 f"CLI's {want} and {n_want}")
        if st["ref_blocks"] != blocks or \
                2 * st["split_chunks"] <= st["chunk_strands"]:
            fail(f"{label}: {st['ref_blocks']} target blocks (expected "
                 f"{blocks}), {st['split_chunks']} of "
                 f"{st['chunk_strands']} chunk-strands cut by max_hits "
                 f"(expected most)")
    print(f"scale-8 and scale-4 split: every route hashes to the JAX CLIs'; "
          f"{time.time() - t3f:.1f} s [{card}]", flush=True)

    t0 = time.time()
    fa["1000"] = (os.path.join(d, "ref1000.fa"),
                  os.path.join(d, "qry1000.fa"))
    bench_inputs.write_scale_inputs("block-1000", *fa["1000"])
    print(f"block-1000 written in {time.time() - t0:.1f} s", flush=True)
    label = "block-1000 cli (native route)"
    r = run_cli_logged(label, pw, [*fa["1000"], *nog, "--wga_chunk_size",
                                   "500000"], {},
                       os.path.join(d, "block_1000"),
                       timeout=BLOCK1000_TIMEOUT)
    st = r["stats"]
    print(scale_line(label, r, False, card), flush=True)
    by_slice[label] = st["launches"]
    for k in native_k:
        if st["launches"][k] == 0:
            fail(f"{label}: {k} was not launched")
    # every chunk-strand past DEFAULT_MAX_HITS (2^26): its hits cut into
    # three batches or more
    if st["ref_blocks"] != 2 or st["min_chunk_hits"] <= 1 << 26 or \
            st["split_chunks"] != st["chunk_strands"]:
        fail(f"{label}: {st['ref_blocks']} target blocks, hits a "
             f"chunk-strand from {st['min_chunk_hits']}, "
             f"{st['split_chunks']} of {st['chunk_strands']} cut by "
             f"max_hits: expected 2 blocks, every chunk-strand past 2^26 "
             f"hits and cut")
    if r["sha256"] != BLOCK1000_SHA256 or st["hsps"] != BLOCK1000_HSPS:
        fail(f"{label}: sha256 {r['sha256']} and {st['hsps']} HSPs, the "
             f"device route's {BLOCK1000_SHA256} and {BLOCK1000_HSPS}")
    peak = max(st["peak_device_bytes"])
    if peak > NATIVE_PEAK_LIMIT:
        fail(f"{label}: max_memory_allocated {peak / 2**30:.2f} GiB, over "
             f"{NATIVE_PEAK_LIMIT / 2**30} GiB")
    print(f"block-1000: the device route's bytes, native peak "
          f"{peak / 2**30:.2f} GiB; phase 3f {time.time() - t3f:.1f} s "
          f"[{card}]", flush=True)
    for f in fa["1000"]:
        os.remove(f)

    # ---- phase 3g: the card's seeding against the host seeder, block-500
    print("phase 3g: the native route's seeding on the card against the "
          "host seeder (native.ChunkSeeder) at block-500, then one "
          "map_chunks over it", flush=True)
    t0 = time.time()
    ref5, query5 = bench_inputs.load_inputs(
        *bench_inputs.SCALE_INPUTS["block-500"][:2])
    t_gen = time.time() - t0
    t0 = time.time()
    al5 = DeviceAligner(**settings)
    al5.set_ref(ref5)
    al5.set_query(query5, revcomp_codes(query5))
    torch.cuda.synchronize()
    print(f"block-500: {len(ref5) / 1e6:.0f} Mbp x {len(query5) / 1e6:.0f} "
          f"Mbp drawn in {t_gen:.1f} s; seed table and upload "
          f"{time.time() - t0:.1f} s, position table "
          f"{al5.pos_table.numel() * 4 / 2**30:.2f} GiB on the card",
          flush=True)
    work5 = bench_inputs.chunk_work(query5)
    seeder = ChunkSeeder(CHUNK, al5.kmer_size, al5.transition)
    it5, pt5 = al5._host_tables
    # the first and the last chunk, both strands
    for w in (*work5[:2], *work5[-2:]):
        t0 = time.time()
        h_r, h_q, _, h_ends, h_seeds, h_hits = seeder.seed(
            al5._q_rc_host if w.rev else al5._q_fw_host, w.chunk_start,
            w.chunk_end - w.chunk_start, it5, pt5, al5.shape_pos,
            al5.seed_size, al5.max_hits)
        t_host = time.time() - t0
        torch.cuda.synchronize()
        t0 = time.time()
        s5 = al5._seed_chunk(w.chunk_start, w.chunk_end, w.rev)
        torch.cuda.synchronize()
        t_card = time.time() - t0
        label = f"chunk-strand {w.chunk_start}:{w.chunk_end} rev={w.rev}"
        if (s5.num_seeds, s5.num_hits) != (h_seeds, h_hits) or \
                not np.array_equal(s5.seg_ends, h_ends):
            fail(f"{label}: the card's seeds, hits and batch ends "
                 f"{s5.num_seeds}, {s5.num_hits}, {s5.seg_ends.tolist()} "
                 f"are not the host seeder's {h_seeds}, {h_hits}, "
                 f"{h_ends.tolist()}")
        t0 = time.time()
        d_r, d_q = (torch.from_numpy(a).to(dev) for a in (h_r, h_q))
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        rows = 0
        for g0 in range(0, s5.num_hits, al5.HBUF):
            r, q, orig = al5._program_hits(s5, g0)
            g1 = g0 + orig.numel()
            bad += ((r != d_r[g0:g1]).sum() + (q != d_q[g0:g1]).sum()
                    + (orig != torch.arange(g0, g1, device=dev)).sum())
            rows += orig.numel()
        bad = int(bad)
        if bad or rows != h_hits:
            fail(f"{label}: {bad} of the card's hit fields differ from the "
                 f"host seeder's, {rows} hits read of {h_hits}")
        print(f"  {label}: {h_hits} hits in {len(h_ends)} batches, every "
              f"hit the host seeder's; seeding on the host {t_host:.3f} s, "
              f"on the card {t_card:.3f} s; compared in "
              f"{time.time() - t0:.1f} s [{card}]", flush=True)
        del d_r, d_q, h_r, h_q, s5
    del it5, pt5
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    results5 = al5.map_chunks(work5, depth=bench_inputs.DEPTH)
    torch.cuda.synchronize()
    dt5 = time.time() - t0
    launches5 = {k: w.launches for k, w in wrappers.items()}
    by_slice["block500_native"] = launches5
    print(f"block-500 native route: {len(work5)} chunk-strands, "
          f"{sum(r.num_hits for r in results5)} hits, "
          f"{sum(len(r.hsps) for r in results5)} HSPs, wall {dt5:.3f} s, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.4f} GiB, "
          f"launches {launches5} [{card}]", flush=True)
    for k in native_k:
        if launches5[k] == 0:
            fail(f"block-500: {k} was not launched")
    del al5, results5, ref5, query5
    torch.cuda.empty_cache()

    # ---- phase 4: the measurement scripts
    print("phase 4: the measurement scripts, in process", flush=True)
    script_kernels = dict(
        gather_dma_only=gv.gather_dma_only,
        gather_extract_only=gv.gather_extract_only,
        gather_dbuf=gv.gather_dbuf, gather_two_sided=gv.gather_two_sided,
        scale2=scale2)
    reset_counts()
    for w in script_kernels.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    exp_gather_variants.main(["3"])
    probe_env.main([], iters=3)
    probe_extension.main([], iters=3)
    torch.cuda.synchronize()
    for k, w in script_kernels.items():
        launches[k] = w.launches
    # K3 is on no path since the native route reads its first windows from
    # the sequences: its launches are probe_extension's
    launches["gather_rows_tile"] = gather_rows_tile.launches
    print(f"scripts: {time.time() - t0:.1f} s, launches "
          f"{dict((k, launches[k]) for k in script_kernels)}, "
          f"gather_rows_tile {launches['gather_rows_tile']} [{card}]",
          flush=True)
    for k in script_kernels:
        if launches[k] == 0:
            fail(f"{k} was not launched by the measurement scripts")
    t0 = time.time()
    measure_scaling.main(["--device", "cuda:0", "--n", "100000",
                          "--counts", "1,2"])
    measure_sharded_vs_replicated.main(["--device", "cuda:0", "--n",
                                        "150000", "--chunk", "75000"])
    print(f"scaling scripts: {time.time() - t0:.1f} s [{card}]", flush=True)

    # ---- phase 4b: the benchmark, in a process of its own, on each route
    for route, route_env in (("native", {}),
                             ("device", {"SEGALIGN_DEVICE_SEEDING": "1"})):
        print(f"phase 4b: python -m segalign_tpu_torch.bench --device cuda "
              f"({route} route) {route_env}", flush=True)
        bench = run_bench(route_env)
        for ps in bench["passes"]:
            print(f"  bench {ps['label']}: seeds, hits, HSPs {ps['counts']}, "
                  f"{ps['mbps']} Mbp/s, max_memory_allocated "
                  f"{ps['peak_gib']} GiB, launches {ps['launches']} [{card}]",
                  flush=True)
        for ps in bench["passes"]:
            label = ps["label"]
            # both routes run K1s and K4s in every pass and neither K2
            # nor K5; the parity's one chunk-strand needs K1s and may need
            # no survivor
            need = (("first_scan_seq",) if label.startswith("parity-")
                    else native_k)
            for k in need:
                if ps["launches"].get(k, 0) == 0:
                    fail(f"bench {label} ({route} route): {k} was not "
                         f"launched")
            for k in ("gather_rows", "window_scan_wide"):
                if ps["launches"].get(k, 0):
                    fail(f"bench {label} ({route} route): {k} was "
                         f"launched")
            if label.startswith("parity-"):
                continue
            family = label.removesuffix("-cold").removesuffix("-serial")
            want = ((n_seeds, n_hits, EXPECTED_HSPS) if family == "repeat-1x"
                    else SWEEP_COUNTS[family])
            if ps["counts"] != want:
                fail(f"bench {label} ({route} route): seeds, hits, HSPs "
                     f"{ps['counts']}, expected {want}")
        labels = [ps["label"] for ps in bench["passes"]]
        want_labels = ["repeat-1x-cold", *["repeat-1x"] * 3,
                       "repeat-1x-serial",
                       *(f"{f}{x}" for f in SWEEP_COUNTS
                         for x in ("-cold", "")),
                       "parity-row", "parity-roww256"]
        if labels != want_labels:
            fail(f"bench ({route} route): passes {labels}, expected "
                 f"{want_labels}")
        last = bench["result"]
        if set(last) != BENCH_KEYS:
            fail(f"bench: last line's keys {sorted(last)} are not the JAX "
                 f"bench's {sorted(BENCH_KEYS)}")
        if last["engine_parity"] != PARITY:
            fail(f"bench ({route} route): engine_parity "
                 f"{last['engine_parity']!r}, expected {PARITY!r}")
        if last["breakdown"]["covered_frac"] < 0.8:
            fail(f"bench ({route} route): the breakdown covers "
                 f"{last['breakdown']['covered_frac']} of its wall, under "
                 f"0.8")
        if bench["gapped"] != (EXPECTED_HSPS, EXPECTED_HSPS):
            fail(f"bench ({route} route): gapped stage {bench['gapped']} "
                 f"(segments, accepted), expected {EXPECTED_HSPS} each")
        prefix = "bench_" if route == "native" else "bench_device_"
        for label in ("repeat-1x", "repeat-0.5x", "repeat-4x",
                      "legacy-planted", "parity-row", "parity-roww256"):
            by_slice[prefix + label] = [
                ps for ps in bench["passes"] if ps["label"] == label][-1][
                    "launches"]
        print(f"bench ({route} route): {bench['seconds']:.1f} s; "
              f"{bench['build']}; {bench['steady']}; breakdown "
              f"{last['breakdown']}; {bench['gapped_line']}; "
              f"{bench['e2e_line']}; result {last} [{card}]", flush=True)

    # the benchmark's first cell, as BENCHMARK.json runs it: its gate,
    # its metrics, and the native route's kernels launched in a pass
    c = next(iter(cells.values()))
    units = bench_cells.metric_units()
    print(f"phase 4b: python -m segalign_tpu_torch.bench --cell {c.name}",
          flush=True)
    t0 = time.time()
    out = bench_process(["--cell", c.name]).stdout.strip().splitlines()
    last = json.loads(out[-1])
    detail = json.loads([ln for ln in out[:-1]
                         if ln.startswith('{"cell"')][-1])
    if not last["correct"] or any(last.get(k) is None for k in units):
        fail(f"cell {c.name}: result {last}, expected correct and every "
             f"metric of {list(units)}")
    for k in native_k:
        if detail["launches"][k] == 0:
            fail(f"cell {c.name}: {k} was not launched in a pass")
    print(f"cell {c.name}: {time.time() - t0:.1f} s; "
          f"{[ln for ln in out if ln.startswith('metric ')]}; counts "
          f"{detail['counts']}, launches {detail['launches']}, layers "
          f"{detail['layers']}, profile {detail['profile']} [{card}]",
          flush=True)
    layers, prof = detail["layers"] or {}, detail["profile"] or {}
    print(f"cell {c.name}: device busy share {prof.get('busy_share')} "
          f"(before the graphs {BEFORE_BUSY_SHARE[0]}-"
          f"{BEFORE_BUSY_SHARE[1]}), serial "
          f"stages {layers.get('stages_s')}, serial wall "
          f"{layers.get('serial_wall_s')} s (medians before the graphs "
          f"{BEFORE_SERIAL_S}) [{card}]", flush=True)

    # ---- phase 5: results
    rows = []
    variants = "segalign_tpu_torch/csrc/gather_variants.cu"
    sources = dict(gather_rows="segalign_tpu_torch/csrc/gather.cu",
                   gather_rows_tile="segalign_tpu_torch/csrc/gather.cu",
                   first_scan="segalign_tpu_torch/csrc/first_scan.cu",
                   first_scan_seq="segalign_tpu_torch/csrc/first_scan.cu",
                   window_scan="segalign_tpu_torch/csrc/window_scan.cu",
                   window_scan_seq="segalign_tpu_torch/csrc/window_scan.cu",
                   window_scan_wide=(
                       "segalign_tpu_torch/csrc/window_scan_wide.cu"),
                   gather_dma_only=variants, gather_extract_only=variants,
                   gather_dbuf=variants, gather_two_sided=variants,
                   scale2="segalign_tpu_torch/csrc/probe.cu")
    replaces = dict(
        gather_rows="segalign_tpu/ops/extend_pallas.py:469",
        gather_rows_tile="segalign_tpu/ops/extend_pallas.py:553",
        first_scan="segalign_tpu/ops/extend_pallas.py:363",
        first_scan_seq="segalign_tpu/ops/extend_pallas.py:363",
        window_scan="segalign_tpu/ops/extend_tiled.py:261",
        # the continuation's steps (segalign_tpu/ops/extend_fused.py:438
        # _run_tail): K2 and K4
        window_scan_seq=("segalign_tpu/ops/extend_pallas.py:469, "
                         "segalign_tpu/ops/extend_tiled.py:261"),
        window_scan_wide="segalign_tpu/ops/extend_pallas.py:212",
        gather_dma_only="scripts/exp_gather_variants.py:109",
        gather_extract_only="scripts/exp_gather_variants.py:109",
        gather_dbuf="scripts/exp_gather_variants.py:109",
        gather_two_sided="scripts/exp_gather_variants.py:169",
        scale2="scripts/probe_env.py:163, scripts/probe_extension.py:159")
    # each kernel's launches on its path: phase 2 (the native route) for
    # first_scan_seq and window_scan_seq (phase 2b, the device-seeding
    # route, launches them too: its counts are in launches_by_slice),
    # phase 4 (the scripts) for K3 and S1-S4; K1 on gathered rows, K2, K4
    # and K5 are on no path (phase 1 checks them; K2 and K5 are the
    # stepped check engine's, which phases 1 and 3e run)
    launched_by = dict(first_scan="no path", first_scan_seq="phase 2",
                       gather_rows="no path", gather_rows_tile="phase 4",
                       window_scan="no path", window_scan_seq="phase 2",
                       window_scan_wide="no path")
    for name in ("first_scan", "first_scan_seq", "gather_rows",
                 "gather_rows_tile", "window_scan", "window_scan_seq",
                 "window_scan_wide", *script_kernels):
        r = K.rows[name]
        rows.append(dict(name=name, route="cuda", source=sources[name],
                         replaces=replaces[name], launches=launches[name],
                         launched_by=launched_by.get(name, "phase 4"),
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         wrapper_ms=r["wrapper_ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"],
                         library_ms=r["library_ms"],
                         launches_by_slice={
                             k: v[name] for k, v in by_slice.items()
                             if name in v}))
        for k in ("variants", "replaced_ms", "steps", "device_route"):
            # {shape: timings} of the other shapes (K1's narrower first
            # window, W = 256; K4s's counts on and rows that never drop);
            # {shape: ms} of the launches first_scan_seq and
            # window_scan_seq took the place of; {shape: survivor steps
            # and their rows} of the launches window_scan_seq replaced;
            # K1s + K4s on the device route's first hit range, and the
            # stepped engine's K2 + K2 + K5 launches they replaced there
            if k in r:
                rows[-1][k] = r[k]
        if name == "gather_rows_tile":
            # {slice: {T: launches}}: which stage size the paths ask for
            rows[-1]["launches_by_T"] = {
                k: {str(T): n for T, n in sorted(v.items())}
                for k, v in by_T.items()}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
