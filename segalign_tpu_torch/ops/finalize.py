"""Host-side entropy finalization of extension candidates.

The device kernel returns raw totals and A/C/G/T match counts for every hit
with total >= hspthresh. The entropy rule
(reference/src/seed_filter.cu:608-648) uses double-precision log, which
TPUs lack natively, so the (few) in-band candidates are finalized here in
float64 — bit-exact with the CUDA kernel.
"""

from __future__ import annotations

import numpy as np


def finalize_candidates(rs, qs, length, total, counts, hspthresh: int,
                        noentropy: bool):
    """Apply the entropy adjustment and final acceptance.

    All inputs are 1-D numpy arrays over candidates (total >= hspthresh
    already guaranteed); counts is (N, 4). Returns (accepted_mask, scores).
    """
    total = np.asarray(total, dtype=np.int64)
    length = np.asarray(length, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    n = len(total)
    entropy = np.ones(n, dtype=np.float64)

    if not noentropy:
        band = (total >= hspthresh) & (total <= 3 * hspthresh)
        csum = counts.sum(axis=1)
        sel = band & (csum >= 20)
        if sel.any():
            ext1 = (length[sel] + 1).astype(np.float64)
            c = counts[sel].astype(np.float64)
            ratio = c / ext1[:, None]
            with np.errstate(divide="ignore", invalid="ignore"):
                term = np.where(c != 0, ratio * np.log(ratio), 0.0)
            entropy[sel] = -term.sum(axis=1) / np.log(4.0)

    # acceptance: (int)((float)total * entropy) >= hspthresh
    adjusted = np.trunc(total.astype(np.float32).astype(np.float64) * entropy)
    accepted = adjusted >= hspthresh
    # stored score: total * entropy truncated, unless entropy == 0
    scores = np.where(entropy > 0,
                      np.trunc(total.astype(np.float64) * entropy),
                      total.astype(np.float64)).astype(np.int64)
    return accepted, scores
