"""LASTZ scoring-file parsing and the gapped-stage scoring model.

The gapped stage scores case-insensitively over {A,C,G,T,N,other} (lastz
ignores soft-masking by default), unlike the ungapped stage's 8-letter
masked alphabet. Codes: A=0 C=1 G=2 T=3 N=4 other=5 '&'=6 (wall).
"""

from __future__ import annotations

import numpy as np

GAP_OPEN_DEFAULT = 400
GAP_EXTEND_DEFAULT = 30

GAPPED_LUT = np.full(256, 5, dtype=np.uint8)
for i, cs in enumerate(("Aa", "Cc", "Gg", "Tt", "Nn")):
    for c in cs:
        GAPPED_LUT[ord(c)] = i
GAPPED_LUT[ord("&")] = 6


def encode_gapped(seq_bytes) -> np.ndarray:
    arr = (np.frombuffer(seq_bytes, dtype=np.uint8)
           if isinstance(seq_bytes, (bytes, bytearray, memoryview))
           else np.asarray(seq_bytes, dtype=np.uint8))
    return GAPPED_LUT[arr]


def default_gapped_matrix(ambiguous: str = "") -> np.ndarray:
    """8x8 int64 matrix over the gapped alphabet (HOXD70-like core, the
    same defaults as reference/src/main.cpp:208-211; N handled per
    --ambiguous like lastz)."""
    sub = np.full((8, 8), -1000, dtype=np.int64)
    core = np.array(
        [[91, -114, -31, -123],
         [-114, 100, -125, -31],
         [-31, -125, 100, -114],
         [-123, -31, -114, 91]], dtype=np.int64)
    sub[:4, :4] = core

    fields = ambiguous.split(",")
    amb = fields[0]
    reward, penalty = -100, -100
    if len(fields) == 3:
        reward, penalty = int(fields[1]), -int(fields[2])
    elif amb in ("n", "iupac"):
        reward, penalty = 0, 0
    if amb in ("n", "iupac"):
        sub[:4, 4] = penalty
        sub[4, :4] = penalty
        sub[4, 4] = reward
    else:
        sub[:4, 4] = -100
        sub[4, :4] = -100
        sub[4, 4] = -100
    # 'other' characters: fill score
    sub[:5, 5] = -100
    sub[5, :5] = -100
    sub[5, 5] = -100
    return sub


def parse_scoring_file(path: str):
    """Parse a LASTZ scoring file: optional settings lines
    (name = value) and a 4x4 (or larger) substitution matrix with a header
    row of nucleotides. Returns (sub8x8 int64, gap_open, gap_extend)."""
    gap_open = GAP_OPEN_DEFAULT
    gap_extend = GAP_EXTEND_DEFAULT
    rows = []
    header = None
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                name, _, val = line.partition("=")
                name = name.strip().lower()
                val = val.strip()
                try:
                    v = int(float(val))
                except ValueError:
                    continue
                if name in ("gap_open_penalty", "o"):
                    gap_open = v
                elif name in ("gap_extend_penalty", "e"):
                    gap_extend = v
                continue
            toks = line.split()
            if header is None and all(len(t) == 1 and not _is_num(t)
                                      for t in toks):
                header = [t.upper() for t in toks]
                continue
            if toks and not _is_num(toks[0]):
                # row label followed by scores
                rows.append((toks[0].upper(), [int(float(x))
                                               for x in toks[1:]]))
            elif toks:
                rows.append((None, [int(float(x)) for x in toks]))

    sub = default_gapped_matrix()
    if header is None:
        header = ["A", "C", "G", "T"]
    code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
    for k, (label, vals) in enumerate(rows):
        r = code.get(label if label else header[k] if k < len(header)
                     else "?", None)
        if r is None:
            continue
        for j, v in enumerate(vals[:len(header)]):
            c = code.get(header[j])
            if c is not None:
                sub[r, c] = v
    return sub, gap_open, gap_extend


def _is_num(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False
