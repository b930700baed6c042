"""Configuration: seed shapes, scoring matrix, and run options.

Replicates the semantics of the reference option handling
(reference/src/main.cpp:61-268 and
reference/repeat_masker_src/main.cpp:41-262) with a dataclass instead of
boost::program_options.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .constants import (
    L_NT, N_NT, X_NT, E_NT, NUC,
    DEFAULT_SEQ_BLOCK_SIZE, DEFAULT_SEQ_BLOCK_SIZE_RM,
    DEFAULT_LASTZ_INTERVAL, DEFAULT_WGA_CHUNK,
)


@dataclasses.dataclass
class SeedConfig:
    shape: str          # resolved shape string of 'T'/'0' columns
    size: int           # window length (len(shape))
    kmer_size: int      # number of sampled ('T') columns
    shape_pos: tuple    # indices of sampled columns
    transition: bool    # allow one-transition seed variants


def resolve_seed_shape(seed_shape: str) -> tuple[str, int]:
    """Resolve a --seed argument to a shape string.

    Mirrors reference/src/main.cpp:160-178, including the quirk that in
    an arbitrary user pattern every character that is not '1' (including a
    literal 'T') becomes a don't-care '0'.
    """
    if seed_shape == "12of19":
        return "TTT0T00TT00T0T0TTTT", 19
    if seed_shape == "14of22":
        return "TTT0T0TT00TT00T0T0TTTT", 22
    shape = "".join("T" if c == "1" else "0" for c in seed_shape)
    return shape, len(seed_shape)


def generate_shape_pos(shape: str) -> tuple[tuple, tuple]:
    """Sampled-column indices and their transition flags.

    Mirrors GenerateShapePos (reference/common/ntcoding.cpp:21-37): a
    column is sampled if it is '1' or 'T'; it is transition-allowed if 'T'.
    After resolve_seed_shape every sampled column is 'T', so in practice all
    sampled columns allow transitions.
    """
    shape_pos = []
    transition_pos = []
    for i, c in enumerate(shape):
        if c in ("1", "T"):
            shape_pos.append(i)
            transition_pos.append(1 if c == "T" else 0)
    return tuple(shape_pos), tuple(transition_pos)


def make_seed_config(seed_shape: str = "12of19", notransition: bool = False) -> SeedConfig:
    shape, size = resolve_seed_shape(seed_shape)
    shape_pos, _ = generate_shape_pos(shape)
    return SeedConfig(
        shape=shape,
        size=size,
        kmer_size=len(shape_pos),
        shape_pos=shape_pos,
        transition=not notransition,
    )


def build_substitution_matrix(xdrop: int, ambiguous: str = "") -> np.ndarray:
    """The 8x8 scoring matrix over the {A,C,G,T,L,N,X,E} alphabet.

    Mirrors reference/src/main.cpp:187-268. Returns int32 [NUC, NUC].
    Notes kept from the reference:
      - HOXD70-like ACGT core.
      - L (soft-masked) rows/cols are bad_score (-1000).
      - N scoring depends on --ambiguous ("n"/"iupac" -> reward/penalty,
        default bad_score).
      - X is fill_score (-100) vs ACGT, bad vs L/N unless iupac.
      - E ('&' separator) rows/cols are -10*xdrop: an impassable wall.
      - A --scoring file is NOT applied to this matrix (the reference passes
        it through to LASTZ only; see reference/src/segment_printer.cpp:106-107).
    """
    ambiguous_reward = -100
    ambiguous_penalty = -100
    fill_score = -100
    bad_score = -1000

    fields = ambiguous.split(",")
    ambiguous_field = fields[0]
    if len(fields) == 3:
        ambiguous_reward = int(fields[1])
        ambiguous_penalty = -int(fields[2])
    elif ambiguous in ("n", "iupac"):
        ambiguous_reward = 0
        ambiguous_penalty = 0

    sub = np.zeros((NUC, NUC), dtype=np.int32)

    core = np.array(
        [[91, -114, -31, -123],
         [-114, 100, -125, -31],
         [-31, -125, 100, -114],
         [-123, -31, -114, 91]], dtype=np.int32)
    sub[:L_NT, :L_NT] = core

    # lower-case (soft-masked)
    sub[:L_NT, L_NT] = bad_score
    sub[L_NT, :L_NT] = bad_score
    sub[L_NT, L_NT] = bad_score

    # N
    if ambiguous_field in ("n", "iupac"):
        sub[:N_NT, N_NT] = ambiguous_penalty
        sub[N_NT, :N_NT] = ambiguous_penalty
        sub[N_NT, N_NT] = ambiguous_reward
    else:
        sub[:N_NT, N_NT] = bad_score
        sub[N_NT, :N_NT] = bad_score
        sub[N_NT, N_NT] = bad_score

    # X (other IUPAC / fill)
    if ambiguous_field == "iupac":
        sub[:X_NT, X_NT] = ambiguous_penalty
        sub[X_NT, :X_NT] = ambiguous_penalty
        sub[X_NT, X_NT] = ambiguous_reward
    else:
        sub[:L_NT, X_NT] = fill_score
        sub[X_NT, :L_NT] = fill_score
        sub[L_NT:X_NT, X_NT] = bad_score
        sub[X_NT, L_NT:X_NT] = bad_score
        sub[X_NT, X_NT] = fill_score

    # E: separator walls
    sub[:E_NT, E_NT] = -10 * xdrop
    sub[E_NT, :E_NT] = -10 * xdrop
    sub[E_NT, E_NT] = -10 * xdrop

    return sub


@dataclasses.dataclass
class Config:
    """Run configuration for the pairwise aligner (segalign equivalent)."""

    reference_filename: str = ""
    query_filename: str = ""
    data_folder: str = ""

    strand: str = "both"                 # plus/minus/both

    scoring_file: str = ""               # passed through to LASTZ only
    ambiguous: str = ""

    seed_shape: str = "12of19"
    step: int = 1
    notransition: bool = False

    xdrop: int = 910
    hspthresh: int = 3000
    noentropy: bool = False

    gapped: bool = True
    ydrop: int = 9430
    gappedthresh: Optional[int] = None
    notrivial: bool = False

    output_format: str = "maf-"
    output: str = ""
    markend: bool = False

    wga_chunk_size: int = DEFAULT_WGA_CHUNK
    lastz_interval_size: int = DEFAULT_LASTZ_INTERVAL
    seq_block_size: int = DEFAULT_SEQ_BLOCK_SIZE
    num_devices: int = -1
    debug: bool = False

    # TPU-specific knobs (no reference equivalent)
    max_hits: int = 0           # 0 => derived from device memory
    use_pallas: bool = True     # Pallas extension engine on TPU (False => XLA step)
    device_hbuf: int = 0        # hit-buffer slots per device dispatch (0=auto)
    device_batch: int = 0       # extension sub-batch rows (0=auto)
    sharded_table: bool = False  # k-mer-sharded seed table over the device
    #                              mesh (v2 scale-out; parallel/sharded.py)

    seed: SeedConfig = None
    sub_mat: np.ndarray = None

    def __post_init__(self):
        if self.gappedthresh is None:
            self.gappedthresh = self.hspthresh
        if self.seed is None:
            self.seed = make_seed_config(self.seed_shape, self.notransition)
        if self.sub_mat is None:
            self.sub_mat = build_substitution_matrix(self.xdrop, self.ambiguous)


@dataclasses.dataclass
class RMConfig:
    """Run configuration for the repeat-masker mode
    (reference/repeat_masker_src/main.cpp:41-262)."""

    seq_filename: str = ""

    strand: str = "both"
    neighbor_proportion: float = 0.2

    scoring_file: str = ""
    ambiguous: str = ""

    seed_shape: str = "12of19"
    step: int = 1
    notransition: bool = False

    xdrop: int = 910
    hspthresh: int = 3000
    noentropy: bool = False

    M: int = 1                  # min coverage depth reported (max 255)
    markend: bool = False

    wga_chunk_size: int = DEFAULT_WGA_CHUNK
    lastz_interval_size: int = DEFAULT_LASTZ_INTERVAL
    seq_block_size: int = DEFAULT_SEQ_BLOCK_SIZE_RM
    num_devices: int = -1
    debug: bool = False

    max_hits: int = 0
    use_pallas: bool = True
    sharded_table: bool = False  # k-mer-sharded table over the device mesh
    #                              (RM blocks are 1 GB vs pairwise 500 MB,
    #                              so RM needs table sharding FIRST)

    seed: SeedConfig = None
    sub_mat: np.ndarray = None

    def __post_init__(self):
        if self.seed is None:
            self.seed = make_seed_config(self.seed_shape, self.notransition)
        if self.sub_mat is None:
            self.sub_mat = build_substitution_matrix(self.xdrop, self.ambiguous)
        # The reference trims the block size to a whole number of intervals
        # (reference/repeat_masker_src/main.cpp:259-262).
        if self.seq_block_size == DEFAULT_SEQ_BLOCK_SIZE_RM:
            self.seq_block_size -= self.seq_block_size % self.lastz_interval_size
