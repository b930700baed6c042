"""The port's own copies of the host modules compute what the originals in
segalign_tpu do: the same inputs, made from a numpy seed, through both, with
zero tolerance. One case per copied module."""

import argparse
import dataclasses
import gzip
import importlib
import io
import json
import os
import re
from contextlib import redirect_stderr

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(name):
    """(original, copy) of one module."""
    return (importlib.import_module(f"segalign_tpu.{name}"),
            importlib.import_module(f"segalign_tpu_torch.{name}"))


def same(a, b):
    """Deep equality of results: arrays exactly (dtype too), dataclasses
    by their fields (the two packages have a class each), containers
    element by element."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert a == b


def _genome(rng, n, repeats=True):
    """Codes 0..5 with a planted repeat, soft-masked and N runs."""
    g = rng.integers(0, 4, n).astype(np.uint8)
    if repeats:
        g[n // 2:n // 2 + n // 8] = g[n // 10:n // 10 + n // 8]
    g[n // 3:n // 3 + 40] = 4
    g[n // 5:n // 5 + 25] = 5
    return g


def _text(codes):
    return np.frombuffer(b"ACGTaNX&", np.uint8)[codes].tobytes().decode()


def _hsps(rng, n, span):
    rs = rng.integers(0, span, n)
    qs = rs + rng.choice([-7, 0, 0, 3, 1000], n)
    # equal tuples, shared diagonals and containments among them
    rs[n // 2:] = rs[:n - n // 2]
    qs[n // 2:] = qs[:n - n // 2]
    ln = rng.integers(10, 400, n)
    sc = rng.integers(3000, 9000, n)
    if n >= 10:
        ln[-5:], sc[-5:] = ln[n // 2 - 5:n // 2], sc[n // 2 - 5:n // 2]
    return tuple(a.astype(np.int64) for a in (rs, np.abs(qs), ln, sc))


def case_constants(tmp_path, rng):
    a, b = both("constants")
    names = [n for n in dir(a) if n.isupper()]
    assert len(names) >= 17 and names == [n for n in dir(b) if n.isupper()]
    for n in names:
        assert getattr(a, n) == getattr(b, n), n


def case_logging_util(tmp_path, rng):
    a, b = both("logging_util")
    assert a.json_logging_enabled() == b.json_logging_enabled()
    out = []
    for m in (a, b):
        was = m._ENABLED
        m._ENABLED = True
        try:
            buf = io.StringIO()
            with redirect_stderr(buf):
                m.log_event("chunk", start=5, hsps=[1, 2], name="x")
        finally:
            m._ENABLED = was
        rec = json.loads(buf.getvalue())
        assert isinstance(rec.pop("ts"), float)
        out.append((rec, re.sub(r'"ts":[0-9.]+', "", buf.getvalue())))
    assert out[0] == out[1]


def case_config(tmp_path, rng):
    a, b = both("config")
    same(a.Config(), b.Config())
    same(a.RMConfig(), b.RMConfig())
    same(a.Config(xdrop=700, hspthresh=2200, ambiguous="iupac",
                  seed_shape="14of22", notransition=True),
         b.Config(xdrop=700, hspthresh=2200, ambiguous="iupac",
                  seed_shape="14of22", notransition=True))
    for shape in ("12of19", "14of22", "1110100110010101111",
                  "T1T01T0011T01T01T11T"):
        same(a.resolve_seed_shape(shape), b.resolve_seed_shape(shape))
        same(a.make_seed_config(shape), b.make_seed_config(shape))
    for xdrop in (910, 1, 12345):
        for amb in ("", "n", "iupac"):
            same(a.build_substitution_matrix(xdrop, amb),
                 b.build_substitution_matrix(xdrop, amb))


def case_io_encode(tmp_path, rng):
    a, b = both("io.encode")
    raw = rng.integers(0, 256, 5000).astype(np.uint8)
    raw[:300] = np.frombuffer(b"ACGTacgtNnXx&-", np.uint8)[
        rng.integers(0, 14, 300)]
    same(a.encode(raw), b.encode(raw))
    same(a.encode(raw.tobytes()), b.encode(raw.tobytes()))
    codes = rng.integers(0, 8, 4001).astype(np.uint8)
    same(a.revcomp_codes(codes), b.revcomp_codes(codes))
    same(a.ENCODE_LUT, b.ENCODE_LUT)
    same(a.COMPLEMENT_LUT, b.COMPLEMENT_LUT)


def case_io_fasta(tmp_path, rng):
    a, b = both("io.fasta")
    recs = [(f"chr{i} description {i}", _text(_genome(rng, n, False)))
            for i, n in enumerate((1300, 61, 60, 1))]
    paths = []
    for tag, m in (("a", a), ("b", b)):
        p = str(tmp_path / f"{tag}.fa")
        m.write_fasta(p, recs)
        m.write_fasta(p + ".w", recs, width=17)
        with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as z:
            z.write(f.read())
        paths.append(p)
    for suffix in ("", ".w"):
        with open(paths[0] + suffix, "rb") as f, \
                open(paths[1] + suffix, "rb") as g:
            assert f.read() == g.read()
    for suffix in ("", ".w", ".gz"):
        same(list(a.read_fasta(paths[0] + suffix)),
             list(b.read_fasta(paths[0] + suffix)))
    assert len(list(b.read_fasta(paths[1]))) == 4


def case_io_blocks(tmp_path, rng):
    a, b = both("io.blocks")
    fa, fb = both("io.fasta")
    recs = [(f"c{i}", _text(_genome(rng, n, False)))
            for i, n in enumerate((900, 2500, 40, 1700, 3100))]
    p = str(tmp_path / "g.fa")
    fa.write_fasta(p, recs)
    for block_size, with_rc in ((10**9, True), (3000, True), (2600, False)):
        ar_a = a.build_arena(fa.read_fasta(p), block_size, with_rc)
        ar_b = b.build_arena(fb.read_fasta(p), block_size, with_rc)
        same(ar_a, ar_b)
        same(ar_a.chr_starts, ar_b.chr_starts)
        if with_rc:
            same(ar_a.rc_chr_starts, ar_b.rc_chr_starts)
        for seed_size, interval in ((19, 1000), (22, 10**7)):
            same(a.plan_intervals(ar_a.blocks, seed_size, interval),
                 b.plan_intervals(ar_b.blocks, seed_size, interval))
    for args in ((0, 1000, 250), (5, 6, 250), (7, 7, 3), (0, 751, 250)):
        same(list(a.chunk_interval(*args)), list(b.chunk_interval(*args)))


def case_index_seed_table(tmp_path, rng):
    a, b = both("index.seed_table")
    ca, cb = both("config")
    ref = _genome(rng, 30_000)
    # 12of19 only: its table has 4^12 entries (14of22's has 4^14)
    sc = ca.make_seed_config("12of19")
    same(sc, cb.make_seed_config("12of19"))
    for step in (1, 7):
        # the port keeps the native build alone: held to the original's
        # numpy version and to its native one
        for use_native in (False, True):
            same(a.build_seed_table(ref, step, sc.shape_pos, sc.size,
                                    sc.kmer_size, use_native=use_native),
                 b.build_seed_table(ref, step, sc.shape_pos, sc.size,
                                    sc.kmer_size))
    short = ref[:10]
    same(a.build_seed_table(short, 1, sc.shape_pos, sc.size, sc.kmer_size,
                            use_native=False),
         b.build_seed_table(short, 1, sc.shape_pos, sc.size, sc.kmer_size))


def case_ops_finalize(tmp_path, rng):
    a, b = both("ops.finalize")
    n = 500
    length = rng.integers(20, 3000, n)
    total = rng.integers(3000, 12000, n)
    counts = rng.integers(0, 200, (n, 4))
    counts[:40] = 0
    counts[40:80, 1:] = 0                # one base only: entropy 0
    counts[80:90] = [[5, 5, 5, 4]]       # fewer than 20 matches
    for noentropy in (False, True):
        same(a.finalize_candidates(None, None, length, total, counts, 3000,
                                   noentropy),
             b.finalize_candidates(None, None, length, total, counts, 3000,
                                   noentropy))


def case_ops_dedup(tmp_path, rng):
    a, b = both("ops.dedup")
    for n in (0, 1, 7, 600):
        h = _hsps(rng, n, 5000) if n else tuple(
            np.zeros(0, np.int64) for _ in range(4))
        for fn in ("dedup_pairwise", "dedup_rm"):
            # the port keeps the native dedup alone: held to the
            # original's numpy version and to its native one
            for use_native in (False, True):
                same(getattr(a, fn)(*h, use_native=use_native),
                     getattr(b, fn)(*h))


def case_native(tmp_path, rng):
    a, b = both("native")
    ca, _ = both("config")
    sa, sb = both("index.seed_table")
    assert a.get_lib() is not None and b.get_lib() is not None
    ref, query = _genome(rng, 40_000), _genome(rng, 30_000)
    query[5000:9000] = ref[11_000:15_000]
    sc = ca.make_seed_config("12of19")
    tables = sa.build_seed_table(ref, 1, sc.shape_pos, sc.size, sc.kmer_size)
    same(tables, sb.build_seed_table(ref, 1, sc.shape_pos, sc.size,
                                     sc.kmer_size))
    chunk = 12_000
    for transition in (True, False):
        seeders = [m.ChunkSeeder(chunk, sc.kmer_size, transition, nthreads=2)
                   for m in (a, b)]
        for start, ln, max_hits in ((0, chunk, 4096), (12_000, chunk, 100),
                                    (24_000, 5981, 1 << 20)):
            got = [s.seed(query, start, ln, *tables, sc.shape_pos, sc.size,
                          max_hits) for s in seeders]
            assert got[0][5] > 0
            same(got[0], got[1])
    n = 300
    rs = rng.integers(0, 20_000, n).astype(np.int64)
    qs = rng.integers(0, 20_000, n).astype(np.int64)
    ln = rng.integers(0, 5000, n).astype(np.int64)
    same(a.entropy_counts_host(ref, query, rs, qs, ln),
         b.entropy_counts_host(ref, query, rs, qs, ln))
    sub = rng.integers(-100, 100, (8, 8)).astype(np.int64)
    np.fill_diagonal(sub, 91)
    same(a.gapped_extend_native(ref, query, sub, 400, 30, 9430, 12_000, 6000),
         b.gapped_extend_native(ref, query, sub, 400, 30, 9430, 12_000, 6000))


def case_output_segments(tmp_path, rng):
    a, b = both("output.segments")
    ca, cb = both("config")
    hs = np.stack(_hsps(rng, 40, 9000), axis=1)
    files = []
    for tag, m, c in (("a", a, ca), ("b", b, cb)):
        d = tmp_path / tag
        d.mkdir()
        ctx = m.PrinterContext(
            r_chr_names=["r1", "r2", "r3"],
            r_chr_starts=np.array([0, 4000, 9500]),
            q_chr_names=["q1", "q2"], q_chr_starts=np.array([0, 7000]),
            rc_q_chr_names=["q2", "q1"],
            rc_q_chr_starts=np.array([0, 5000]),
            rc_q_chr_lens=np.array([5000, 7000]), out_dir=str(d))
        cfg = c.Config(data_folder="/data/", gapped=True, notrivial=True,
                       ambiguous="iupac", scoring_file="s.q")
        cmds = m.write_interval_segments(
            ctx, cfg, num_invoked=3, q_block_index=1, r_block_index=2,
            r_block_start=500, q_block_start=100, fw_hsps=hs[:25],
            rc_hsps=hs[25:])
        assert m.write_interval_segments(
            ctx, cfg, num_invoked=4, q_block_index=1, r_block_index=2,
            r_block_start=0, q_block_start=0, fw_hsps=hs[:0],
            rc_hsps=hs[:0]) == []
        files.append((cmds, {f: (d / f).read_bytes()
                             for f in sorted(os.listdir(d))}))
    assert len(files[0][0]) == 2 and len(files[0][1]) == 2
    assert files[0] == files[1]


def case_output_merge(tmp_path, rng):
    a, b = both("output.merge")
    names = ["tmp10.block0.r0.plus.segments", "tmp2.block0.r0.plus.segments",
             "tmp2.block1.r500.minus.segments", "tmp1.block0.r0.minus.maf",
             "tmp1.block10.r0.plus.maf", "tmp1.block9.r0.plus.maf"]
    outs = []
    for tag, m in (("a", a), ("b", b)):
        d = tmp_path / tag
        d.mkdir()
        for n in names:
            (d / n).write_text(f"{n}\n")
        listed = [os.path.basename(p)
                  for p in m.sorted_glob(str(d / "tmp*"))]
        m.merge_outputs(str(d), str(tmp_path / f"{tag}.out"), markend=True)
        outs.append((listed, (tmp_path / f"{tag}.out").read_bytes(),
                     sorted(os.listdir(d))))
        same([m.version_key(n) for n in names],
             [a.version_key(n) for n in names])
    assert outs[0] == outs[1] and outs[0][2] == []
    assert outs[0][0][0].startswith("tmp1.") and b"end-of-file" in outs[0][1]


def case_output_scoring(tmp_path, rng):
    a, b = both("output.scoring")
    p = tmp_path / "scores.q"
    p.write_text("# a scoring file\ngap_open_penalty = 350\n"
                 "gap_extend_penalty=25\n\n"
                 "     A     C     G     T\n"
                 "A   91  -114   -31  -123\nC -114   100  -125   -31\n"
                 "G  -31  -125   100  -114\nT -123   -31  -114    91\n")
    same(a.parse_scoring_file(str(p)), b.parse_scoring_file(str(p)))
    for amb in ("", "n", "iupac"):
        same(a.default_gapped_matrix(amb), b.default_gapped_matrix(amb))
    raw = rng.integers(0, 256, 2000).astype(np.uint8)
    same(a.encode_gapped(raw), b.encode_gapped(raw))
    assert (a.GAP_OPEN_DEFAULT, a.GAP_EXTEND_DEFAULT) == (
        b.GAP_OPEN_DEFAULT, b.GAP_EXTEND_DEFAULT)


def case_output_gapped(tmp_path, rng):
    a, b = both("output.gapped")
    assert a.have_lastz() == b.have_lastz()
    assert a.have_fa_to_two_bit() == b.have_fa_to_two_bit()
    got = []
    for tag, m in (("a", a), ("b", b)):
        d = tmp_path / tag
        d.mkdir()
        (d / "x.err").write_text("")
        (d / "y.err").write_text("warning only\n")
        ok = m.check_lastz_errors(str(d))
        left = sorted(os.listdir(d))
        (d / "z.err").write_text("FAILURE: bad\n")
        buf = io.StringIO()
        with redirect_stderr(io.TextIOWrapper(io.BytesIO())):
            bad = m.check_lastz_errors(str(d))
        pool = m.LastzPool(str(d), max_jobs=2)
        for k in range(3):
            pool.submit(f"echo {k} > out{k}.txt")
        pool.submit("exit 3")
        pool.wait_all()
        got.append((ok, left, bad, sorted(os.listdir(d)), pool.count,
                    pool.failures, buf.getvalue()))
    assert got[0] == got[1]
    assert got[0][:3] == (False, [], True) and got[0][4:6] == (4, 1)


def case_output_native_gapped(tmp_path, rng):
    a, b = both("output.native_gapped")
    ca, cb = both("config")
    fa, _ = both("io.fasta")
    ref = _genome(rng, 6000, False)
    query = _genome(rng, 5000, False)
    core = ref[1000:3000].copy()
    mut = rng.random(2000) < 0.08
    core[mut] = (core[mut] + 1) % 4
    query[1500:3500] = np.append(np.delete(core, [700, 701]), [0, 1])
    fa.write_fasta(str(tmp_path / "ref.fa"), [("r", _text(ref))])
    fa.write_fasta(str(tmp_path / "query.fa"), [("q", _text(query))])
    outs = []
    for tag, m, c in (("a", a, ca), ("b", b, cb)):
        for fmt in ("maf-", "cigar"):
            d = tmp_path / f"{tag}_{fmt}"
            d.mkdir()
            (d / "tmp1.block0.r0.plus.segments").write_text(
                "r\t1201\t1501\tq\t1701\t2001\t+\t20000\n")
            cfg = c.Config(reference_filename=str(tmp_path / "ref.fa"),
                           query_filename=str(tmp_path / "query.fa"),
                           output_format=fmt, notrivial=True)
            n = m.run_native_gapped(cfg, str(d), max_workers=1)
            outs.append((tag, n, {f: (d / f).read_bytes()
                                  for f in sorted(os.listdir(d))}))
    half = len(outs) // 2
    for x, y in zip(outs[:half], outs[half:]):
        assert x[1:] == y[1:] and x[1] == 1
        # an alignment came out, with its indel
        assert any(b"score=15" in v or (b"cigar: q" in v and b" D 2 " in v)
                   for k, v in x[2].items() if not k.endswith(".segments"))


def case_pipeline_manifest(tmp_path, rng):
    a, b = both("pipeline.manifest")
    assert a.MANIFEST_NAME == b.MANIFEST_NAME
    texts = []
    for tag, m in (("a", a), ("b", b)):
        d = tmp_path / tag
        d.mkdir()
        man = m.Manifest(str(d))
        man.mark_done((0, 1, 2), files=["tmp2.x"])
        man.mark_done((3, 0, 1))
        man.close()
        with open(man.path, "a") as f:
            f.write('{"r": 9, "q": 9, "i"')      # a torn write
        again = m.Manifest(str(d), resume=True)
        assert again.is_done((0, 1, 2)) and again.is_done((3, 0, 1))
        assert not again.is_done((9, 9, 9)) and not again.is_done((1, 1, 1))
        again.close()
        assert m.Manifest(str(d)).done == set()
        texts.append((d / m.MANIFEST_NAME).read_text())
    assert texts[0] == texts[1]


def case_cli_args(tmp_path, rng):
    a, b = both("cli.args")
    argvs = [["ref.fa", "query.fa"],
             ["ref.fa", "query.fa", "--nogapped", "--output", "o.seg",
              "--markend", "--xdrop", "700", "--hspthresh", "2500",
              "--seed", "14of22", "--step", "2", "--notransition",
              "--strand", "plus", "--format", "cigar", "--noentropy",
              "--wga_chunk", "1000", "--ambiguous", "iupac"]]
    for argv in argvs:
        na, nb = (m.build_pairwise_parser().parse_args(argv) for m in (a, b))
        assert vars(na) == vars(nb)
        same(a.pairwise_config_from_args(na), b.pairwise_config_from_args(nb))
    for argv in (["seq.fa"], ["seq.fa", "--M", "3", "--markend", "--output",
                              "o", "--neighbor_proportion", "0.5",
                              "--hspthresh", "2000"]):
        na, nb = (m.build_rm_parser().parse_args(argv) for m in (a, b))
        assert vars(na) == vars(nb)
        same(a.rm_config_from_args(na), b.rm_config_from_args(nb))

    def options(p: argparse.ArgumentParser):
        # one help string is the port's own: its coordinator is
        # torch.distributed's
        return sorted((tuple(x.option_strings), x.dest, repr(x.default),
                       (x.help or "").replace("torch.distributed",
                                              "jax.distributed"))
                      for x in p._actions)
    (coord,) = [x for x in b.build_pairwise_parser()._actions
                if x.dest == "coordinator"]
    assert "torch.distributed" in coord.help and "jax" not in coord.help
    assert options(a.build_pairwise_parser()) == options(
        b.build_pairwise_parser())
    assert options(a.build_rm_parser()) == options(b.build_rm_parser())


def case_parallel_distributed(tmp_path, rng):
    a, b = both("parallel.distributed")
    for n in (0, 1, 7, 12):
        ivs = [object() for _ in range(n)]
        for num_hosts in (1, 2, 3, 5):
            parts = []
            for host in range(num_hosts):
                got = b.partition_intervals(ivs, host, num_hosts)
                assert got == a.partition_intervals(ivs, host, num_hosts)
                parts.append(got)
            assert sorted(map(id, sum(parts, []))) == sorted(map(id, ivs))


def case_parallel_sharded(tmp_path, rng):
    a, b = both("parallel.sharded")
    table = importlib.import_module("segalign_tpu.index.seed_table")
    sc = importlib.import_module("segalign_tpu.config").make_seed_config(
        "12of19")
    for n in (0, 30, 5000):
        tables = table.build_seed_table(_genome(rng, n), 1, sc.shape_pos,
                                        sc.size, sc.kmer_size)
        for S in (2, 4, 16):
            same(a.shard_seed_table(*tables, S), b.shard_seed_table(*tables,
                                                                    S))
    # every bucket of a small table filled, so no shard is empty
    index = np.cumsum(rng.integers(0, 5, 64)).astype(np.int32)
    pos = rng.integers(0, 1000, int(index[-1])).astype(np.int32)
    for S in (2, 8, 64):
        same(a.shard_seed_table(index, pos, S),
             b.shard_seed_table(index, pos, S))


def case_rm_header(tmp_path, rng):
    a, b = both("cli.run_segalign_repeat_masker")
    assert a.HEADER == b.HEADER and a.HEADER.startswith("#name1")


def case_native_sources(tmp_path, rng):
    """The three C++ sources are the originals', but for the prefix of the
    reference tree's paths in their comments."""
    for f in ("native.cpp", "seeder.cpp", "gapped.cpp"):
        with open(os.path.join(ROOT, "segalign_tpu", "native", f), "rb") as g:
            want = g.read()
        with open(os.path.join(ROOT, "segalign_tpu_torch", "native", f),
                  "rb") as g:
            got = g.read()
        marker = b"reference/"
        at = [m.start() for m in re.finditer(marker, want)]
        assert at, f
        # drop whatever precedes each "reference/" back to the last
        # blank or bracket: the two files must then be byte-equal
        strip = re.compile(rb"[^\s(]*reference/")
        assert strip.sub(marker, want) == strip.sub(marker, got), f
        assert len(want.splitlines()) == len(got.splitlines())


def case_bench_inputs(tmp_path, rng):
    import sys
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import bench
    from segalign_tpu_torch import bench_inputs
    was = bench.REF_MBP, bench.QUERY_MBP
    bench.REF_MBP, bench.QUERY_MBP = 0.3, 0.2
    try:
        env = {k: os.environ.pop(k, None)
               for k in ("BENCH_REF_FASTA", "BENCH_QUERY_FASTA")}
        try:
            want = bench.load_inputs()
        finally:
            os.environ.update({k: v for k, v in env.items()
                               if v is not None})
    finally:
        bench.REF_MBP, bench.QUERY_MBP = was
    same(want, bench_inputs.load_inputs(0.3, 0.2))
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    partner = _genome(rng, 100_000)
    lib_a = bench.make_repeat_library(ra)
    lib_b = bench_inputs.make_repeat_library(rb)
    same(lib_a, lib_b)
    same(bench.synth_genome_repeats(ra, 150_000, lib_a,
                                    homolog_from=partner, repeat_mult=2.0),
         bench_inputs.synth_genome_repeats(rb, 150_000, lib_b,
                                           homolog_from=partner,
                                           repeat_mult=2.0))
    # the density sweep's and legacy-planted's generators, alone and with
    # a partner, at an n past 1 Mbp, where every loop of theirs runs
    for mult in (0.5, 4.0):
        for hf in (None, partner):
            same(bench.synth_genome_repeats_sweep(
                     ra, 1_050_000, lib_a, homolog_from=hf,
                     repeat_mult=mult),
                 bench_inputs.synth_genome_repeats_sweep(
                     rb, 1_050_000, lib_b, homolog_from=hf,
                     repeat_mult=mult))
    for hf in (None, partner):
        same(bench.synth_genome(ra, 1_050_000, homolog_from=hf),
             bench_inputs.synth_genome(rb, 1_050_000, homolog_from=hf))
    assert bench.CHUNK == bench_inputs.CHUNK
    # make_aligner's settings, read from its source (calling it would
    # build a JAX aligner)
    import inspect
    src = inspect.getsource(bench.make_aligner)
    for text in (f'make_seed_config("{bench_inputs.SEED}")',
                 f"build_substitution_matrix({bench_inputs.XDROP})",
                 f"transition={bench_inputs.TRANSITION}",
                 f"step={bench_inputs.STEP}", f"xdrop={bench_inputs.XDROP}",
                 f"hspthresh={bench_inputs.HSPTHRESH}",
                 f"noentropy={bench_inputs.NOENTROPY}"):
        assert text in src, text
    import torch
    from segalign_tpu.config import build_substitution_matrix, \
        make_seed_config
    got = bench_inputs.aligner_settings(torch.device("cpu"))
    sc = make_seed_config(bench_inputs.SEED)
    same(got.pop("sub_mat"), build_substitution_matrix(bench_inputs.XDROP))
    assert got.pop("device") == torch.device("cpu")
    same(got, dict(shape_pos=sc.shape_pos, seed_size=sc.size,
                   transition=True, step=1, xdrop=910, hspthresh=3000,
                   noentropy=False, chunk_size=bench.CHUNK))
    # the chunk list of bench.py's timed loop: both strands of every chunk
    query = want[1]
    q_len = len(query) - sc.size
    assert [(w.chunk_start, w.chunk_end, w.rev)
            for w in bench_inputs.chunk_work(query)] == [
        (cs, min(cs + bench.CHUNK, q_len), rev)
        for cs in range(0, q_len, bench.CHUNK) for rev in (False, True)]
    fb = importlib.import_module("segalign_tpu_torch.io.fasta")
    p = str(tmp_path / "codes.fa")
    bench_inputs.write_codes_fasta(p, partner)
    (rec,) = fb.read_fasta(p)
    assert rec.name == "ref"
    same(importlib.import_module("segalign_tpu_torch.io.encode").encode(
        rec.seq), partner)


CASES = [case_constants, case_logging_util, case_config, case_io_encode,
         case_io_fasta, case_io_blocks, case_index_seed_table,
         case_ops_finalize, case_ops_dedup, case_native,
         case_output_segments, case_output_merge, case_output_scoring,
         case_output_gapped, case_output_native_gapped,
         case_pipeline_manifest, case_cli_args, case_parallel_distributed,
         case_parallel_sharded, case_rm_header,
         case_native_sources, case_bench_inputs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_copy_equals_original(case, tmp_path):
    case(tmp_path, np.random.default_rng(sum(map(ord, case.__name__))))
