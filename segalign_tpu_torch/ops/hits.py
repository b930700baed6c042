"""Hit expansion and candidate compaction, in plain PyTorch.

Counterpart of segalign_tpu/ops/hits.py. expand_hits turns a range of
flat hit indices into (ref_loc, query_loc) pairs: a binary search over the
seeds' cumulative hit counts finds the owning seed, and the offset into
its bucket indexes the position table. compact_mask packs the rows of a
mask to the front, in a stable order.
"""

from __future__ import annotations

import torch


def expand_hits(cum, starts, qpos, pos_table, g0: int, g1: int,
                seed_size: int, *, HBUF: int, with_seed: bool = False):
    """Hits [g0, g1) (at most HBUF) as (ref_loc, query_loc, valid), each
    (HBUF,); locations include the +seed_size offset of the reference's
    find_hits. Rows past g1 - g0 are not valid. g0 and g1 are ints or
    0-d int32 tensors on cum's device (the native route's programs, whose
    graph reads them from the device). with_seed adds a fourth array: the
    index into cum of each hit's seed."""
    dev = cum.device
    lanes = torch.arange(HBUF, dtype=torch.int32, device=dev)
    # from the lanes, not from g: g0 + lane wraps past 2^31 - 1 on rows
    # past g1 of a program that ends near there
    valid = lanes < g1 - g0
    g = g0 + lanes
    gs = torch.where(valid, g, 0)
    sidx = torch.searchsorted(cum, gs, right=True).to(torch.int32)
    sidx = torch.clamp(sidx, max=cum.shape[0] - 1)
    # sidx - 1 is -1 at sidx 0, where the where() picks 0: clamp it, since
    # torch indexing would wrap it to the last seed
    prev = torch.where(sidx > 0, cum[(sidx - 1).clamp(min=0).long()], 0)
    bucket_pos = starts[sidx.long()] + (gs - prev)
    bucket_pos = bucket_pos.clamp(0, pos_table.shape[0] - 1)
    ref_loc = pos_table[bucket_pos.long()] + seed_size
    query_loc = qpos[sidx.long()] + seed_size
    if with_seed:
        return ref_loc, query_loc, valid, sidx
    return ref_loc, query_loc, valid


def compact_mask(mask, *arrays):
    """Pack the rows where `mask` is true to the front of same-shaped
    arrays, in order, the other rows after them in order (a stable sort on
    ~mask). Returns (n, *packed) with n the 0-d int32 count of true rows."""
    perm = torch.cat([torch.nonzero(mask).squeeze(1),
                      torch.nonzero(~mask).squeeze(1)])
    return (mask.sum(dtype=torch.int32), *(a[perm] for a in arrays))
