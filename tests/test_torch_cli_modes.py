"""The one-device surface of the port's CLIs beyond a plain --nogapped run,
against the JAX CLIs byte for byte: the native gapped stage in every output
format it writes, single strands, the device-seeding route, a query of
several blocks and intervals, --gapped_mode delegate without lastz,
--workdir/--resume, and a subset of the oracle fuzz on both seeding
routes. Everything runs on the CPU."""

import importlib.util
import os

import numpy as np
import pytest

from segalign_tpu.io.fasta import write_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def revcomp_str(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp.get(c, c) for c in reversed(s))


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """The pair of tests/test_native_gapped_e2e.py: the query carries the
    core with a 15 bp deletion and point mutations on one chromosome, and
    its reverse complement on another."""
    rng = np.random.default_rng(99)
    d = tmp_path_factory.mktemp("cli_modes")
    core = rand_dna(rng, 600)
    qcore = list(core[:300] + core[315:])
    for p in (50, 150, 400):
        qcore[p] = "ACGT"[("ACGT".index(qcore[p]) + 1) % 4]
    qcore = "".join(qcore)
    t_chr = rand_dna(rng, 400) + core + rand_dna(rng, 400)
    q_chr1 = rand_dna(rng, 250) + qcore + rand_dna(rng, 300)
    q_chr2 = rand_dna(rng, 200) + revcomp_str(core) + rand_dna(rng, 250)
    ref_fa, query_fa = str(d / "t.fa"), str(d / "q.fa")
    write_fasta(ref_fa, [("tchr", t_chr)])
    write_fasta(query_fa, [("qchr1", q_chr1), ("qchr2", q_chr2)])
    return [ref_fa, query_fa]


def _jax_main(argv):
    from segalign_tpu.cli.run_segalign import main
    return main(argv)


def _port_main(argv):
    from segalign_tpu_torch.cli.run_segalign import main
    return main([*argv, "--device", "cpu"])


def _both(argv, tmp_path, port_env=None, monkeypatch=None):
    """The bytes the JAX CLI and the port's write for one command line."""
    outs = []
    for name, main in (("jax", _jax_main), ("port", _port_main)):
        out = str(tmp_path / f"{name}.out")
        if name == "port" and port_env:
            for k, v in port_env.items():
                monkeypatch.setenv(k, v)
        assert main([*argv, "--output", out]) == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    return outs


GAPPED = ["--gapped_mode", "native", "--hspthresh", "1800", "--gappedthresh",
          "3000", "--wga_chunk_size", "512", "--lastz_interval_size", "1000"]


@pytest.mark.parametrize("fmt", ["maf-", "sam", "axt", "cigar",
                                 "differences"])
def test_native_gapped_formats_identical_to_jax(fmt, genomes, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    want, got = _both([*genomes, *GAPPED, "--format", fmt], tmp_path)
    assert got == want
    assert want.count(b"\n") >= 2
    assert not [d for d in os.listdir(tmp_path) if d.startswith("output_")]


@pytest.mark.parametrize("main", [_jax_main, _port_main],
                         ids=["jax", "port"])
def test_native_gapped_general_format_raises(main, genomes, tmp_path,
                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="general"):
        main([*genomes, *GAPPED, "--format", "general-", "--output",
              str(tmp_path / "out")])


NOGAPPED = ["--nogapped", "--markend", "--hspthresh", "1800",
            "--wga_chunk_size", "512"]
MODES = {
    "plus": (["--strand", "plus", "--lastz_interval_size", "1000"], None),
    "minus": (["--strand", "minus", "--lastz_interval_size", "1000"], None),
    "device_seeding": (["--lastz_interval_size", "1000"],
                       {"SEGALIGN_DEVICE_SEEDING": "1"}),
    # two query blocks of three intervals each
    "blocks": (["--seq_block_size", "1000", "--lastz_interval_size", "400"],
               None),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_nogapped_modes_identical_to_jax(mode, genomes, tmp_path,
                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    extra, port_env = MODES[mode]
    want, got = _both([*genomes, *NOGAPPED, *extra], tmp_path, port_env,
                      monkeypatch)
    assert got == want
    lines = want.decode().splitlines()
    assert lines[-1] == "# segalign end-of-file" and len(lines) > 1
    strands = {ln.split("\t")[6] for ln in lines[:-1]}
    assert strands == {"plus": {"+"}, "minus": {"-"}}.get(mode, {"+", "-"})


def test_blocks_mode_has_several_blocks_and_intervals(genomes):
    from segalign_tpu_torch.io.blocks import build_arena, plan_intervals
    from segalign_tpu_torch.io.fasta import read_fasta
    arena = build_arena(read_fasta(genomes[1]), 1000, with_rc=True)
    ivs = plan_intervals(arena.blocks, 19, 400)
    assert len(arena.blocks) == 2
    assert max(iv.num_intervals for iv in ivs) > 1


@pytest.mark.parametrize("main", [_jax_main, _port_main],
                         ids=["jax", "port"])
def test_delegate_without_lastz_exits_4(main, genomes, tmp_path, monkeypatch,
                                        capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))   # no lastz, no faToTwoBit
    assert main([*genomes, "--gapped_mode", "delegate"]) == 4
    assert ("error: --gapped_mode=delegate requires `lastz` and `faToTwoBit` "
            "on PATH; use --gapped_mode=native or --nogapped"
            ) in capsys.readouterr().err
    assert not [d for d in os.listdir(tmp_path) if d.startswith("output_")]


def _files(d, suffix):
    out = {}
    for f in os.listdir(d):
        if f.endswith(suffix):
            with open(os.path.join(d, f)) as fh:
                out[f] = fh.read()
    return out


def _resume_case(kind, tmp_path):
    """(run(out_dir, resume) -> stats, the suffix of its output files)."""
    rng = np.random.default_rng(17)
    if kind == "pairwise":
        # the genomes and settings of tests/test_resume.py
        from segalign_tpu_torch.config import Config
        from segalign_tpu_torch.pipeline.pairwise import run_pairwise
        core = rand_dna(rng, 300)
        ref_fa, query_fa = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
        write_fasta(ref_fa, [("t", rand_dna(rng, 500) + core
                              + rand_dna(rng, 1500))])
        write_fasta(query_fa, [("q", rand_dna(rng, 200) + core
                                + rand_dna(rng, 1800))])

        def run(out_dir, resume):
            cfg = Config(
                reference_filename=ref_fa, query_filename=query_fa,
                data_folder="", gapped=False, noentropy=True, hspthresh=1500,
                wga_chunk_size=512, lastz_interval_size=800,
                seq_block_size=10**6, device_hbuf=1024)
            return run_pairwise(cfg, out_dir, device="cpu", resume=resume)
        return run, ".segments"
    from segalign_tpu_torch.config import RMConfig
    from segalign_tpu_torch.pipeline.repeat_masker import run_repeat_masker
    rep = rand_dna(rng, 250)
    seq_fa = str(tmp_path / "seq.fa")
    write_fasta(seq_fa, [
        ("chr1", rand_dna(rng, 300) + rep + rand_dna(rng, 200) + rep
         + rand_dna(rng, 300)),
        ("chr2", rand_dna(rng, 250) + rep + rand_dna(rng, 350))])

    def run(out_dir, resume):
        cfg = RMConfig(seq_filename=seq_fa, hspthresh=1500, noentropy=True,
                       wga_chunk_size=512, lastz_interval_size=700,
                       seq_block_size=1400)
        return run_repeat_masker(cfg, out_dir, device="cpu", resume=resume)
    return run, ".intervals"


@pytest.mark.parametrize("kind", ["pairwise", "rm"])
def test_resume_skips_done_intervals(kind, tmp_path):
    run, suffix = _resume_case(kind, tmp_path)
    out1, out2 = str(tmp_path / "o1"), str(tmp_path / "o2")
    os.makedirs(out1)
    os.makedirs(out2)
    s1 = run(out1, False)
    files1 = _files(out1, suffix)
    assert files1 and s1.num_seeds > 0

    # a finished run, one file deleted: the resumed run skips every
    # interval, so it seeds nothing and does not write the file again
    run(out2, False)
    victim = sorted(_files(out2, suffix))[0]
    os.remove(os.path.join(out2, victim))
    s3 = run(out2, True)
    assert s3.num_seeds == 0 and s3.intervals_done == s1.intervals_done
    assert not os.path.exists(os.path.join(out2, victim))

    # without resume everything runs again and the file comes back
    s4 = run(out2, False)
    assert s4.num_seeds == s1.num_seeds
    assert _files(out2, suffix) == files1


def _fuzz_module():
    spec = importlib.util.spec_from_file_location(
        "fuzz_oracle", os.path.join(ROOT, "scripts", "fuzz_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("device_seeding", [False, True],
                         ids=["native", "device"])
@pytest.mark.parametrize("seed", [1001, 1003, 1004, 1006, 1008])
def test_fuzz_parity_subset(seed, device_seeding, monkeypatch):
    """scripts/fuzz_oracle.py's run_case (random genome structure, seed
    shape, xdrop, hspthresh, max_hits, chunk size, RM window, noentropy;
    every chunk-strand's hit count and HSPs against the numpy oracle) with
    the port's aligner in the JAX aligner's place. run_case imports its
    aligner from segalign_tpu.pipeline.device when it is called."""
    import segalign_tpu.pipeline.device as jax_device
    from segalign_tpu_torch.pipeline.device import DeviceAligner

    def port_aligner(*, B, W, **kw):
        # B and W size the JAX aligner's programs; they change no output
        return DeviceAligner(device="cpu", device_seeding=device_seeding,
                             **kw)

    monkeypatch.setattr(jax_device, "DeviceAligner", port_aligner)
    report = _fuzz_module().run_case(seed)
    assert report.startswith(f"seed={seed} ") and report.endswith(" OK")
