"""Seeding of one query chunk on the device: spaced-seed k-mers with their
transition variants, and the hit count of each seed.

Counterpart of segalign_tpu/ops/seeding.py chunk_seeds, in plain PyTorch
(the JAX version is XLA, not a Pallas kernel). chunk_kmers is the part that
reads no seed table, which the sharded aligner calls on its own
(parallel/sharded.py), and bucket_ranges the table lookup. Seed slot order is the
reference's: position-major, then the base k-mer, then its k transition
variants; the hit-batch boundaries depend on it. The cumulative hit count
is an int32 cumsum with int32 wraparound, as in the JAX package (whose
blocked cumsum only works around an XLA lowering); the hit count in stats
is an exact int64 sum, so that a caller can tell a chunk whose cumsum
wrapped (the JAX package's int32 count wraps with it).
"""

from __future__ import annotations

import torch

from ..constants import TRANSITION_MASK


def chunk_kmers(query_pad, chunk_start: int, chunk_len: int, *, CHUNK: int,
                seed_size: int, shape_pos: tuple, transition: bool,
                pad: int):
    """The seed slots of chunk [chunk_start, chunk_start + chunk_len), with
    no seed table read: (kmers, qpos, valid), all (S,) with S = CHUNK *
    (1 + k) with transitions (CHUNK without). query_pad as for chunk_seeds.
    """
    k = len(shape_pos)
    nvar = 1 + k if transition else 1
    s0 = pad + chunk_start
    if s0 < 0 or s0 + seed_size - 1 + CHUNK > query_pad.numel():
        raise ValueError(
            f"query_pad of {query_pad.numel()} bytes is too short for "
            f"chunk_start={chunk_start}, CHUNK={CHUNK}, pad={pad}")
    dev = query_pad.device
    cols = [query_pad[s0 + i:s0 + i + CHUNK].to(torch.int32)
            for i in range(seed_size)]
    j = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    valid_pos = j < chunk_len
    for c in cols:
        valid_pos &= c < 4
    kmer = torch.zeros(CHUNK, dtype=torch.int32, device=dev)
    for i, sp in enumerate(shape_pos):
        kmer |= (cols[sp] & 3) << (2 * (k - 1 - i))
    if transition:
        xors = torch.tensor([0] + [TRANSITION_MASK << (2 * t)
                                   for t in range(k)],
                            dtype=torch.int32, device=dev)
        kmers = (kmer[:, None] ^ xors[None, :]).reshape(-1)
    else:
        kmers = kmer
    qpos = (chunk_start + j).repeat_interleave(nvar)
    valid = valid_pos.repeat_interleave(nvar)
    return kmers, qpos, valid


def bucket_ranges(index_table, buckets, starts=None):
    """(starts, ends) of buckets in a table of inclusive bucket ends,
    looked up with the buckets' own integer type (no int64 copy of them);
    starts: a tensor that receives the starts, or None for a new one."""
    ends = torch.index_select(index_table, 0, buckets)
    # buckets - 1 is -1 at bucket 0, whose start is 0
    starts = torch.index_select(index_table, 0, (buckets - 1).clamp_(min=0),
                                out=starts)
    starts.masked_fill_(buckets == 0, 0)
    return starts, ends


def chunk_seeds(query_pad, index_table, chunk_start: int, chunk_len: int, *,
                CHUNK: int, seed_size: int, shape_pos: tuple,
                transition: bool, pad: int, out=None):
    """The seeds of chunk [chunk_start, chunk_start + chunk_len).

    query_pad: 1-D uint8 padded query with `pad` bytes before position 0,
    at least chunk_start + CHUNK + seed_size - 1 bytes past `pad`;
    index_table: (4^k,) int32 bucket ends. Returns (kmers, qpos, valid,
    starts, cum, stats), all (S,) with S = CHUNK * (1 + k) with transitions
    (CHUNK without): cum is the inclusive int32 cumsum of the per-seed hit
    counts (0 for invalid slots); stats is (2,) int64: the number of valid
    seeds and of hits. out: (qpos, starts, cum), (S,) int32 tensors on the
    device that receive those three (the native route's program buffers,
    which a CUDA graph reads), or None for new ones."""
    kmers, qpos, valid = chunk_kmers(
        query_pad, chunk_start, chunk_len, CHUNK=CHUNK, seed_size=seed_size,
        shape_pos=shape_pos, transition=transition, pad=pad)
    if out is None:
        out = [torch.empty_like(kmers) for _ in range(3)]
    out_qpos, starts, cum = out
    out_qpos.copy_(qpos)
    del qpos
    _, hit_counts = bucket_ranges(index_table, kmers, starts)   # the ends
    hit_counts.sub_(starts).masked_fill_(~valid, 0)
    stats = torch.stack([valid.sum(), hit_counts.sum(dtype=torch.int64)])
    torch.cumsum(hit_counts, 0, dtype=torch.int32, out=cum)
    return kmers, out_qpos, valid, starts, cum, stats
