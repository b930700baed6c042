"""Synthetic benchmark inputs: a genome pair with repeat and homology
structure, and the aligner settings, the chunk list and the repeat-masker
input the pair is measured with.

The generators are copies of the root bench.py's. Each draws from one
numpy Generator in a fixed order, so a seed fixes the pair: load_inputs()
gives the repeat-1x 4 Mbp x 4 Mbp pair (rng 2024) on which the aligner
finds 8351 HSPs, and make_inputs() gives each of the benchmark's input
families by name. chip_smoke.py drives the port's paths on the repeat-1x
pair, scripts/slice_walls.py times the same slices and bench.py runs every
family: they take the settings, the chunk list and the FASTA from here.
"""

from __future__ import annotations

import numpy as np

from .config import build_substitution_matrix, make_seed_config
from .io.fasta import write_fasta
from .parallel.multi import ChunkWork

CHUNK = 250_000
# the settings the pair is aligned with: seed pattern, transitions, step,
# the score of the default substitution matrix's wall, x-drop, HSP
# threshold, entropy adjustment on
SEED = "12of19"
TRANSITION = True
STEP = 1
XDROP = 910
HSPTHRESH = 3000
NOENTROPY = False
# chunk-strands map_chunks keeps in flight on the native seeding route
DEPTH = 6


def synth_genome(rng, n, homolog_from=None, identity=0.85, repeat_frac=0.10):
    """Round-1..3 generator: planted diverged homology on a uniform
    background (extension-dominated; ~6.2e6 hits/Mbp at 4 Mbp)."""
    seq = rng.integers(0, 4, n).astype(np.uint8)
    if homolog_from is not None:
        # plant diverged copies of segments of the partner genome
        total = int(n * repeat_frac)
        placed = 0
        while placed < total:
            ln = int(rng.integers(2_000, 30_000))
            src = int(rng.integers(0, len(homolog_from) - ln))
            dst = int(rng.integers(0, n - ln))
            core = homolog_from[src:src + ln]
            mut = rng.random(ln) >= identity
            seq[dst:dst + ln] = np.where(
                mut, (core + rng.integers(1, 4, ln)) % 4, core)
            placed += ln
    # soft-masked and N stretches like real assemblies
    for _ in range(n // 500_000):
        p = int(rng.integers(0, n - 1000))
        seq[p:p + int(rng.integers(100, 1000))] = 4
    for _ in range(n // 1_000_000):
        p = int(rng.integers(0, n - 500))
        seq[p:p + int(rng.integers(50, 500))] = 5
    return seq


def make_repeat_library(rng):
    """Shared repeat library for a genome PAIR: interspersed repeat family
    consensus sequences (SINE/LINE-like length mix) and microsatellite
    units. Both genomes draw copies from the SAME library — ancient
    shared families are what give real pairs their heavy-tailed
    cross-genome seed-hit distribution."""
    fams = [(150, 0.10), (300, 0.10), (600, 0.14), (1500, 0.16),
            (5000, 0.18)]
    lib = [(rng.integers(0, 4, ln).astype(np.uint8), div)
           for ln, div in fams]
    units = [np.array(u, np.uint8) for u in
             ([0, 3], [1, 0], [1, 0, 2], [3, 3, 0, 2, 2, 1])]
    return lib, units


def synth_genome_repeats(rng, n, lib, homolog_from=None, identity=0.85,
                         homology_frac=0.10, repeat_mult=1.0):
    """Repeat-structured generator: interspersed family copies (fragmented,
    per-copy diverged, mostly soft-masked like RepeatMasker output),
    shared-unit tandem arrays, planted diverged homology, soft-masked runs
    and N gaps. repeat_mult scales UNMASKED repeat content and thereby the
    seed-hit density (reported, not assumed)."""
    fams, units = lib
    seq = rng.integers(0, 4, n).astype(np.uint8)
    # ~25% repeat-derived sequence, ~88% of copies soft-masked: genomes
    # fed to whole-genome aligners are post-RepeatMasker (that is what
    # the reference RM mode produces), so only the masker's misses stay
    # seedable — those drive the cross-genome repeat HSPs
    budget = int(n * 0.25 * 0.12 * repeat_mult)
    while budget > 0:
        cons, div = fams[int(rng.integers(0, len(fams)))]
        ln = len(cons)
        take = int(rng.integers(ln // 4, ln + 1))   # 5'-truncated copies
        frag = cons[ln - take:]
        mut = rng.random(take) < div * rng.uniform(0.3, 1.7)
        copy = np.where(mut, (frag + rng.integers(1, 4, take)) % 4, frag)
        p = int(rng.integers(0, n - take))
        if rng.random() < 0.88:
            seq[p:p + take] = 4        # soft-masked copy: no seeds
        else:
            seq[p:p + take] = copy
            budget -= take
    for _ in range(max(1, n // 250_000)):           # tandem arrays
        u = units[int(rng.integers(0, len(units)))]
        reps = int(rng.integers(20, 400))
        arr = np.tile(u, reps)[:8000]
        p = int(rng.integers(0, n - len(arr)))
        if rng.random() < 0.85:
            seq[p:p + len(arr)] = 4
        else:
            seq[p:p + len(arr)] = arr
    if homolog_from is not None:
        placed = 0
        total = int(n * homology_frac)
        while placed < total:
            ln = int(rng.integers(2_000, 30_000))
            src = int(rng.integers(0, len(homolog_from) - ln))
            dst = int(rng.integers(0, n - ln))
            core = homolog_from[src:src + ln]
            mut = rng.random(ln) >= identity
            seq[dst:dst + ln] = np.where(
                mut, (core + rng.integers(1, 4, ln)) % 4, core)
            placed += ln
    for _ in range(n // 1_000_000):                 # N gaps
        p = int(rng.integers(0, n - 500))
        seq[p:p + int(rng.integers(50, 500))] = 5
    return seq


def synth_genome_repeats_sweep(rng, n, lib, homolog_from=None,
                               repeat_mult=1.0):
    """Density-sweep generator: like synth_genome_repeats but with the
    SEEDABLE repeat content controlled deterministically so repeat_mult
    moves measured hits/Mbp monotonically (VERDICT r4 weak #6: the old
    sweep's density was dominated by coin-flips on whether the few
    tandem arrays stayed unmasked). Exact counts, not probabilities:
    unmasked interspersed budget and unmasked tandem-array count both
    scale linearly with repeat_mult; masked copies stay fixed."""
    fams, units = lib
    seq = rng.integers(0, 4, n).astype(np.uint8)
    budget = int(n * 0.03 * repeat_mult)        # unmasked interspersed
    while budget > 0:
        cons, div = fams[int(rng.integers(0, len(fams)))]
        ln = len(cons)
        take = int(rng.integers(ln // 4, ln + 1))
        frag = cons[ln - take:]
        mut = rng.random(take) < div * rng.uniform(0.3, 1.7)
        copy = np.where(mut, (frag + rng.integers(1, 4, take)) % 4, frag)
        p = int(rng.integers(0, n - take))
        seq[p:p + take] = copy
        budget -= take
    for _ in range(n // 200_000):               # masked copies (no seeds)
        cons, _ = fams[int(rng.integers(0, len(fams)))]
        take = int(rng.integers(len(cons) // 4, len(cons) + 1))
        p = int(rng.integers(0, n - take))
        seq[p:p + take] = 4
    n_tandem = max(1, round(n / 1e6 * repeat_mult))  # unmasked tandems
    for _ in range(n_tandem):
        u = units[int(rng.integers(0, len(units)))]
        arr = np.tile(u, int(rng.integers(20, 400)))[:8000]
        p = int(rng.integers(0, n - len(arr)))
        seq[p:p + len(arr)] = arr
    if homolog_from is not None:
        placed = 0
        total = int(n * 0.10)
        while placed < total:
            ln = int(rng.integers(2_000, 30_000))
            src = int(rng.integers(0, len(homolog_from) - ln))
            dst = int(rng.integers(0, n - ln))
            core = homolog_from[src:src + ln]
            mut = rng.random(ln) >= 0.85
            seq[dst:dst + ln] = np.where(
                mut, (core + rng.integers(1, 4, ln)) % 4, core)
            placed += ln
    for _ in range(n // 1_000_000):
        p = int(rng.integers(0, n - 500))
        seq[p:p + int(rng.integers(50, 500))] = 5
    return seq


def load_inputs(ref_mbp: float = 4.0, query_mbp: float = 4.0):
    """The repeat-1x pair (ref, query) as uint8 code arrays, rng 2024."""
    rng = np.random.default_rng(2024)
    lib = make_repeat_library(rng)
    ref = synth_genome_repeats(rng, int(ref_mbp * 1e6), lib)
    query = synth_genome_repeats(rng, int(query_mbp * 1e6), lib,
                                 homolog_from=ref)
    return ref, query


# the benchmark's input families, in the order it runs them
FAMILIES = ("repeat-1x", "repeat-0.5x", "repeat-4x", "legacy-planted")


def make_inputs(name: str, ref_mbp: float = 4.0, query_mbp: float = 4.0):
    """(ref, query) of one of FAMILIES, as bench.py draws them:
    repeat-1x is load_inputs(ref_mbp, query_mbp); repeat-0.5x and
    repeat-4x are the density sweep, both genomes min(ref_mbp, 2) Mbp with
    that repeat_mult, from rng 7000 + 10 x mult; legacy-planted is
    synth_genome's pair from rng 2024."""
    if name == "repeat-1x":
        return load_inputs(ref_mbp, query_mbp)
    if name in ("repeat-0.5x", "repeat-4x"):
        mult = float(name[len("repeat-"):-1])
        n = int(min(ref_mbp, 2.0) * 1e6)
        rng = np.random.default_rng(7000 + int(mult * 10))
        lib = make_repeat_library(rng)
        ref = synth_genome_repeats_sweep(rng, n, lib, repeat_mult=mult)
        query = synth_genome_repeats_sweep(rng, n, lib, homolog_from=ref,
                                           repeat_mult=mult)
        return ref, query
    if name == "legacy-planted":
        rng = np.random.default_rng(2024)
        ref = synth_genome(rng, int(ref_mbp * 1e6))
        return ref, synth_genome(rng, int(query_mbp * 1e6), homolog_from=ref)
    raise ValueError(f"unknown input family {name!r}; one of {FAMILIES}")


def aligner_settings(device) -> dict:
    """DeviceAligner's keyword arguments for the pair."""
    sc = make_seed_config(SEED)
    return dict(shape_pos=sc.shape_pos, seed_size=sc.size,
                transition=TRANSITION, step=STEP,
                sub_mat=build_substitution_matrix(XDROP), xdrop=XDROP,
                hspthresh=HSPTHRESH, noentropy=NOENTROPY, chunk_size=CHUNK,
                device=device)


def chunk_work(query, chunk: int = CHUNK) -> list:
    """Both strands of every `chunk` bases of the query, in map_chunks'
    order."""
    q_len = len(query) - make_seed_config(SEED).size
    return [ChunkWork(cs, min(cs + chunk, q_len), rev)
            for cs in range(0, q_len, chunk) for rev in (False, True)]


def write_codes_fasta(path: str, codes, name: str = "ref") -> None:
    """A code array as a one-record FASTA (the repeat masker's input)."""
    write_fasta(path, [(name, np.frombuffer(b"ACGTaNX&", np.uint8)[
        codes].tobytes())])


def write_records_fasta(path: str, codes, names, lengths,
                        width: int = 60) -> None:
    """A code array cut into named records of the given lengths (which
    must sum to its length), written as a multi-record FASTA of `width`
    columns, byte for byte what write_fasta writes for those records:
    soft-masked code 4 as lowercase, N as N (write_codes_fasta's
    mapping)."""
    if len(names) != len(lengths) or sum(lengths) != len(codes):
        raise ValueError(f"{len(names)} names and record lengths summing "
                         f"to {sum(lengths)} for {len(codes)} bases")
    ascii_ = np.frombuffer(b"ACGTaNX&", np.uint8)[codes]
    with open(path, "wb") as f:
        start = 0
        for name, ln in zip(names, lengths):
            rec = ascii_[start:start + ln]
            start += ln
            f.write(f">{name}\n".encode())
            full = ln // width * width
            # whole lines as one (rows, width + 1) block with a newline
            # column, then the short last line
            lines = np.empty((full // width, width + 1), np.uint8)
            lines[:, :width] = rec[:full].reshape(-1, width)
            lines[:, width] = ord("\n")
            f.write(lines.tobytes())
            if full < ln:
                f.write(rec[full:].tobytes() + b"\n")


# The genome-scale inputs: the repeat-1x generator (load_inputs, rng 2024)
# at the size of a small genome pair or of one full default target block
# (--seq_block_size, 500 Mbp), each genome cut into records of equal length
# the way assemblies are laid out. name: (ref Mbp, query Mbp, (ref record
# prefix, count), (query record prefix, count)). The query's records of
# scale-8 and scale-16 (1.6 Mbp) end inside the 250 kb chunks and the
# 10 Mbp lastz intervals. scale-4 is scale-8's layout at 4 Mbp: the size at
# which the JAX repeat masker's CLI finishes on a CPU within the hour.
# block-1000 is two full default target blocks (records of 20 Mbp: the
# 25th closes a block), the whole-genome shape on the target side.
SCALE_INPUTS = {
    "scale-4": (4, 4, ("chr", 8), ("q", 5)),
    "scale-8": (8, 8, ("chr", 8), ("q", 5)),
    "scale-16": (16, 16, ("chr", 16), ("q", 10)),
    "block-500": (500, 1, ("chr", 25), ("q", 1)),
    "block-1000": (1000, 1, ("chr", 50), ("q", 1)),
}


def record_layout(prefix: str, count: int, total: int):
    """Names prefix1..prefixN and the lengths of `count` records that cut
    `total` bases evenly, the last taking the remainder."""
    lengths = [total // count] * count
    lengths[-1] += total - sum(lengths)
    return [f"{prefix}{i + 1}" for i in range(count)], lengths


def write_scale_inputs(name: str, ref_path: str, query_path: str):
    """Write the scale input `name` (SCALE_INPUTS) as a reference and a
    query FASTA; returns the (ref, query) code arrays."""
    if name not in SCALE_INPUTS:
        raise ValueError(f"unknown scale input {name!r}; one of "
                         f"{tuple(SCALE_INPUTS)}")
    ref_mbp, query_mbp, ref_rec, query_rec = SCALE_INPUTS[name]
    ref, query = load_inputs(ref_mbp, query_mbp)
    write_records_fasta(ref_path, ref, *record_layout(*ref_rec, len(ref)))
    write_records_fasta(query_path, query,
                        *record_layout(*query_rec, len(query)))
    return ref, query
