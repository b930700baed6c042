"""HSP dedup: thrust sort/unique chains on the host.

Replicates the pairwise dedup (src/seed_filter.cu:769-782)
and the repeat-masker 4-stage dedup
(repeat_masker_src/seed_filter.cu:819-831) exactly, including
thrust::unique_copy's compare-against-last-KEPT chain semantics.

The sorts and the containment chain run in the native host library
(native/native.cpp); a failed build or load of it raises.
"""

from __future__ import annotations

import numpy as np

from ..native import dedup_pairwise_native, dedup_rm_native


def _dedup(native, rs, qs, ln, sc):
    rs = np.asarray(rs, np.int64)
    qs = np.asarray(qs, np.int64)
    ln = np.asarray(ln, np.int64)
    sc = np.asarray(sc, np.int64)
    if len(rs) == 0:
        return rs, qs, ln, sc
    return native(rs, qs, ln, sc)


def dedup_pairwise(rs, qs, ln, sc):
    """Pairwise-mode dedup of one hit batch. Inputs/outputs int64 arrays;
    returns (rs, qs, ln, sc) in final LASTZ output order:
      sort hspComp(diag, ref_start, len asc; score desc)
      -> unique(same diagonal and contained, or same ref_start)
      -> sort hspCompLastz(query_start, ref_start, len asc; score desc)."""
    return _dedup(dedup_pairwise_native, rs, qs, ln, sc)


def dedup_rm(rs, qs, ln, sc):
    """Repeat-masker-mode dedup of one hit batch
    (repeat_masker_src/seed_filter.cu:819-831):
      sort hspComp(qs, len desc, rs, score desc) -> unique(exact equality)
      -> sort hspDiagComp(diag, rs, qs, score desc) -> unique(containment)
      -> sort hspFinalComp(qs asc, score desc, rs desc)."""
    return _dedup(dedup_rm_native, rs, qs, ln, sc)
