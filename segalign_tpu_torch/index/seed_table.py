"""Seed position table build (host).

Equivalent of GenerateSeedPosTable (common/seed_pos_table.cu:49-109 of the
reference). The reference builds the table on CPU with TBB atomics
(nondeterministic bucket order); this one is a counting sort in the native
host library (native/seeder.cpp): deterministic ascending-position buckets,
output equivalent. A failed build or load of the library raises.

Returns int32 arrays sized for direct device upload:
  index_table[4**k]  — inclusive cumulative bucket counts
  pos_table[n]       — block-relative positions, bucket-major
"""

from __future__ import annotations

import numpy as np

from ..native import build_seed_table_fast


def build_seed_table(ref_codes: np.ndarray, step: int, shape_pos,
                     seed_size: int, kmer_size: int):
    assert 3 < kmer_size <= 15
    return build_seed_table_fast(ref_codes, step, shape_pos, seed_size,
                                 kmer_size)
