"""Sequence arenas, block decomposition, and interval planning.

This is the TPU-native equivalent of the reference's DRAM-arena loading and
block/interval planning (reference/src/main.cpp:304-462 query,
:479-541 target; reference/repeat_masker_src/main.cpp:270-432 for the
repeat-masker mode). Semantics preserved exactly:

  - Chromosomes are concatenated with single '&' separator bytes; a block is
    closed when its length exceeds seq_block_size, in which case the closing
    chromosome gets NO trailing separator; the final block's trailing
    separator is excluded from its length.
  - Each block is reverse-complemented into a parallel rc arena whose
    coordinates coincide with the forward arena block starts.
  - Intervals of lastz_interval_size cover [0, block_len - seed_size).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .encode import encode, revcomp_codes
from ..constants import E_NT


@dataclass
class Chrom:
    name: str
    file_idx: int     # ordinal in input file (q_chr_file_name equivalent)
    start: int        # absolute arena position
    len: int


@dataclass
class Block:
    index: int
    start: int        # absolute arena position
    len: int          # excludes any trailing separator
    chroms: List[int] = field(default_factory=list)  # chrom indices in block


@dataclass
class Interval:
    start: int        # block-relative
    end: int          # block-relative, exclusive
    block: int        # block index
    num_invoked: int  # 1-based ordinal within its block (printer file naming)
    num_intervals: int
    # repeat-masker window restriction (block-relative ref positions)
    ref_start: int = 0
    ref_end: int = 0


@dataclass
class SeqArena:
    """A genome loaded as one concatenated uint8 code array."""
    codes: np.ndarray                 # forward arena (uint8 codes)
    rc_codes: np.ndarray | None       # per-block revcomp arena (uint8 codes)
    chroms: List[Chrom]
    rc_chroms: List[Chrom] | None     # chrom table in rc-arena coordinates
    blocks: List[Block]

    @property
    def chr_starts(self) -> np.ndarray:
        return np.array([c.start for c in self.chroms], dtype=np.int64)

    @property
    def rc_chr_starts(self) -> np.ndarray:
        return np.array([c.start for c in self.rc_chroms], dtype=np.int64)


def build_arena(records, seq_block_size: int, with_rc: bool) -> SeqArena:
    """Load FASTA records into an arena with block decomposition.

    `records` is an iterable of FastaRecord. Mirrors the query/target loading
    loop of reference/src/main.cpp:336-455.
    """
    pieces: List[np.ndarray] = []
    chroms: List[Chrom] = []
    blocks: List[Block] = []
    rc_pieces: List[np.ndarray] = []
    rc_chroms: List[Chrom] | None = [] if with_rc else None

    pos = 0                    # arena write position
    block_start = 0
    block_len = 0
    block_chrs: List[int] = []
    sep = np.array([E_NT], dtype=np.uint8)

    def close_block(final: bool):
        nonlocal block_start, block_len, block_chrs
        if final:
            if block_len == 0:
                return
            block_len -= 1  # drop trailing separator from the block extent
        b = Block(index=len(blocks), start=block_start, len=block_len,
                  chroms=list(block_chrs))
        blocks.append(b)
        if with_rc:
            # rc chrom table entries, reversed chromosome order within the
            # block (reference/src/main.cpp:365-370)
            for ci in reversed(block_chrs):
                c = chroms[ci]
                rc_chroms.append(Chrom(
                    name=c.name, file_idx=c.file_idx,
                    start=2 * block_start + block_len - c.start - c.len,
                    len=c.len))
        block_start = pos
        block_len = 0
        block_chrs = []

    for rec in records:
        seq_codes = encode(rec.seq)
        ci = len(chroms)
        chroms.append(Chrom(name=rec.name, file_idx=ci, start=pos,
                            len=len(seq_codes)))
        block_chrs.append(ci)
        pieces.append(seq_codes)
        pos += len(seq_codes)
        block_len += len(seq_codes)
        if block_len > seq_block_size:
            close_block(final=False)
        else:
            pieces.append(sep)
            pos += 1
            block_len += 1

    close_block(final=True)

    codes = (np.concatenate(pieces) if pieces
             else np.zeros(0, dtype=np.uint8))

    rc_codes = None
    if with_rc:
        for b in blocks:
            rc_pieces.append(revcomp_codes(codes[b.start:b.start + b.len]))
        rc_codes = (np.concatenate(rc_pieces) if rc_pieces
                    else np.zeros(0, dtype=np.uint8))

    return SeqArena(codes=codes, rc_codes=rc_codes, chroms=chroms,
                    rc_chroms=rc_chroms, blocks=blocks)


def plan_intervals(blocks: List[Block], seed_size: int,
                   interval_size: int) -> List[Interval]:
    """Pairwise-mode interval list (reference/src/main.cpp:380-393)."""
    out: List[Interval] = []
    for b in blocks:
        n0 = len(out)
        curr = 0
        end_pos = b.len - seed_size
        while curr < end_pos:
            out.append(Interval(start=curr, end=min(end_pos, curr + interval_size),
                                block=b.index, num_invoked=0, num_intervals=0))
            curr += interval_size
        n = len(out) - n0
        for k in range(n0, len(out)):
            out[k].num_invoked = k - n0 + 1
            out[k].num_intervals = n
    return out


def chunk_interval(start: int, end: int, chunk_size: int):
    """Split an interval into wga chunks (reference/src/seeder.cpp:48-51)."""
    i = start
    while i < end:
        yield i, min(i + chunk_size, end)
        i += chunk_size
