"""FASTA reading (plain or gzip) into numpy byte arrays.

Replaces the reference's kseq/zlib reader (reference/common/kseq.h,
used at reference/src/main.cpp:312-460). Names follow kseq semantics:
the record name is the header text up to the first whitespace.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class FastaRecord:
    name: str
    seq: np.ndarray  # uint8 raw ASCII bytes (whitespace removed)


def _open_maybe_gzip(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path: str) -> Iterator[FastaRecord]:
    """Iterate records. Sequence bytes are returned verbatim apart from
    whitespace removal (case is preserved; soft-masking matters)."""
    with _open_maybe_gzip(path) as f:
        data = f.read()
    if not data:
        return
    # Split on header lines. kseq treats both '>' and '@' as headers for
    # FASTA/FASTQ; we only support FASTA here.
    pos = data.find(b">")
    if pos < 0:
        raise ValueError(f"{path}: not a FASTA file (no '>' header)")
    while pos >= 0 and pos < len(data):
        hdr_end = data.find(b"\n", pos)
        if hdr_end < 0:
            return
        header = data[pos + 1:hdr_end].strip()
        name = header.split()[0].decode() if header else ""
        nxt = data.find(b"\n>", hdr_end)
        seq_chunk = data[hdr_end + 1: None if nxt < 0 else nxt + 1]
        seq = np.frombuffer(seq_chunk, dtype=np.uint8)
        # remove all ASCII whitespace (\t \n \v \f \r ' ')
        ws = (seq == 32) | ((seq >= 9) & (seq <= 13))
        if ws.any():
            seq = seq[~ws]
        yield FastaRecord(name=name, seq=seq)
        pos = -1 if nxt < 0 else nxt + 1


def write_fasta(path: str, records, width: int = 60) -> None:
    """Utility for tests: write (name, bytes/str) records."""
    with open(path, "w") as f:
        for name, seq in records:
            if isinstance(seq, (bytes, bytearray)):
                seq = seq.decode()
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")
