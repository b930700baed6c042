"""The seed table sharded by k-mer range, with seeds routed to their owners.

Counterpart of segalign_tpu/parallel/sharded.py. The replicated modes hold
the whole seed position table on every device, which caps the reference
block by one device's memory. Here shard s of S owns the k-mers whose top
log2(S) bits equal s (owner = kmer >> (2 * kmer_size - log2 S)); buckets
are contiguous, so a shard holds one slice of the index table and one of
the position table. The sequences are held once a device.

Per chunk-strand:
  1. seeding    each shard extracts the seeds of its 1/S slice of the
                chunk's positions (ops/seeding.py chunk_kmers), so the
                shards' slots, end to end, are the chunk's slots in the
                reference's order
  2. routing    seeds go to their owners (exchange: an all_to_all), each
                with its global slot
  3. expansion  the owner counts and expands hits from its own slices
                (absolute positions, so nothing is re-based)
  4. batches    the counts go back to slot order (the exchange, reversed)
                and are gathered; their cumsum is the replicated device
                route's, and so are the logical hit-batch limits, as seed
                slots: a hit's batch is that of its seed's slot
  5. extension  the port's windowed engine (ops/extend3.py, window step
                K5) runs on the shard against the replicated sequences,
                with the repeat masker's window applied after expansion
  6. gather     candidates of all shards come to the host with their batch
                ids; finalize_sharded finalizes and dedups per batch

The result equals DeviceAligner's for every chunk-strand. Shards are
logical: `--device cpu` or `cuda:K` holds them all, so S = 2 or 4 runs on
one card and on the CPU; `--device cuda` gives each a card of its own.

With a torch.distributed process group the shards spread over its ranks:
rank r holds the S_local shards of its own devices, global shards
r * S_local .. (r + 1) * S_local - 1 of S = world * S_local, and keeps on
its devices only their slices of the table (every rank builds the whole
table on the host). `exchange` becomes the group's all_to_all_single and
`gather_to` its all_gather_into_tensor: the seeds go to their owners' ranks
and the counts back, every rank gathers the global slot counts, and every
rank gathers all candidates and returns the same ChunkResult (the JAX
program's replicated outputs). The ranks run one program: each must call
set_ref, set_query and map_chunks with the same arguments, in the same
order, and every early exit is decided on a value that came through a
collective, so no rank leaves while the others wait in one. Over gloo the
collectives move host tensors (a shard on a card copies through host
memory); over NCCL they move the tensors on the card.

What the JAX module carries for XLA's static shapes has no counterpart:
the fixed capacities of seeds, hits, candidates and batch limits, their
overflow flag and the fourfold escalation. Tensors here are sized by the
data.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..index.seed_table import build_seed_table
from ..native import check_chunk_hits
from ..ops.extend3 import extend_hits_windowed
from ..ops.hits import expand_hits
from ..ops.padding import pad_sequence
from ..ops.seeding import bucket_ranges, chunk_kmers
from ..pipeline.device import (DEFAULT_MAX_HITS, PAD, ChunkResult,
                               _batch_limits, finalize_batch, on_device)
from .multi import resolve_devices


def shard_seed_table(index_table: np.ndarray, pos_table: np.ndarray,
                     n_shards: int):
    """Slice a host-built table by k-mer range.

    Returns (index_shards (S, R) int32, pos_shards (S, Pmax) int32):
      index_shards[s] — inclusive cumulative bucket counts LOCAL to the
                        shard (base subtracted)
      pos_shards[s]   — the shard's positions (absolute), zero-padded to
                        the widest shard
    """
    K = len(index_table)
    assert K % n_shards == 0
    R = K // n_shards
    idx = np.asarray(index_table, np.int64)
    bases = np.concatenate([[0], idx[R - 1::R]])  # shard start offsets
    index_shards = (idx.reshape(n_shards, R)
                    - bases[:-1, None]).astype(np.int32)
    pmax = int(np.max(bases[1:] - bases[:-1])) if len(pos_table) else 1
    pmax = max(pmax, 1)
    pos_shards = np.zeros((n_shards, pmax), np.int32)
    for s in range(n_shards):
        lo, hi = int(bases[s]), int(bases[s + 1])
        pos_shards[s, :hi - lo] = pos_table[lo:hi]
    return index_shards, pos_shards


def shard_devices(device, num_devices: int = -1,
                  world: int = 1) -> List[torch.device]:
    """The device of each of a process's shards: the first S_local of the
    farm's devices for the same request (parallel/multi.py
    resolve_devices), S_local the largest power of two not above their
    number. world: the processes of the group, each with as many shards;
    together they need two shards at least."""
    pool = resolve_devices(device, num_devices)
    S = 1 << (len(pool).bit_length() - 1)
    if S * world < 2:
        raise ValueError("--sharded_table needs >= 2 devices")
    return pool[:S]


def _rank_world(group):
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def comm_device(group, device) -> torch.device:
    """Where a collective's tensors lie: host memory for gloo, the shard's
    card for NCCL."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device(device)


def exchange(send: List[torch.Tensor], sizes: List[List[int]],
             devices: List[torch.device], group=None) -> List[torch.Tensor]:
    """The all_to_all between the shards.

    sizes is the S x S matrix of the whole group: sizes[s][d] columns go
    from global shard s to global shard d. send[l] is a (rows, n) tensor on
    this process's l-th shard's device (global shard first + l, first =
    rank * len(send)) whose columns are grouped by destination, in global
    shard order. Returns recv[m] on the m-th shard's device: the groups
    sent to it, in global source order. Without a group this process holds
    every shard; with one, the columns for each rank go as contiguous
    (n, rows) rows through all_to_all_single with uneven splits, and are
    split again by (source shard, destination shard)."""
    if group is None:
        parts = [torch.split(t, sz, dim=1) for t, sz in zip(send, sizes)]
        return [torch.cat([p[d].to(dev) for p in parts], dim=1)
                for d, dev in enumerate(devices)]
    rank, world = _rank_world(group)
    L = len(send)
    first = rank * L
    comm = comm_device(group, devices[0])
    # to rank q, source-major: each local shard's columns for q's shards
    # are one contiguous slice, since columns are grouped by destination
    pieces, in_splits = [], []
    for q in range(world):
        n_q = 0
        for l in range(L):
            row = sizes[first + l]
            lo = sum(row[:q * L])
            hi = lo + sum(row[q * L:(q + 1) * L])
            pieces.append(send[l][:, lo:hi].T.to(comm))
            n_q += hi - lo
        in_splits.append(n_q)
    x = torch.cat(pieces).contiguous()
    # from rank p, in its order: source shard p * L + l, then destination
    # shard first + m
    blocks = [[sizes[p * L + l][first + m] for l in range(L)
               for m in range(L)] for p in range(world)]
    y = torch.empty((sum(map(sum, blocks)), x.shape[1]), dtype=x.dtype,
                    device=comm)
    dist.all_to_all_single(y, x, [sum(b) for b in blocks], in_splits,
                           group=group)
    recv: List[List[torch.Tensor]] = [[] for _ in range(L)]
    for k, part in enumerate(torch.split(y, sum(blocks, []))):
        recv[k % L].append(part)
    return [torch.cat(r).T.contiguous().to(dev)
            for r, dev in zip(recv, devices)]


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t (the same shape on every rank) end to end."""
    _, world = _rank_world(group)
    out = torch.empty((world * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def gather_to(parts: List[torch.Tensor], device,
              group=None) -> torch.Tensor:
    """The all_gather: the shards' tensors end to end on `device`, in global
    shard order. Across processes every rank gets the same tensor: the row
    counts go first, then the rows padded to the largest, trimmed after."""
    if group is None:
        return torch.cat([p.to(device) for p in parts])
    comm = comm_device(group, parts[0].device)
    local = torch.cat([p.to(comm) for p in parts])
    n = _all_gather(torch.tensor([local.shape[0]], dtype=torch.int64,
                                 device=comm), group).tolist()
    width = max(n)
    padded = torch.zeros((width, *local.shape[1:]), dtype=local.dtype,
                         device=comm)
    padded[:local.shape[0]] = local
    out = _all_gather(padded, group)
    return torch.cat([out[r * width:r * width + k]
                      for r, k in enumerate(n)]).to(device)


def finalize_sharded(rows: np.ndarray, *, hspthresh: int, noentropy: bool,
                     rm_mode: bool = False, rev: bool = False,
                     ref_len: int = 0) -> np.ndarray:
    """Host finalize of the gathered candidates, (n, 9) int64 rows of rs,
    qs, length, total, counts[4] and the batch id: entropy and accept, then
    dedup per logical hit batch; (n, 4) int64 HSPs in batch order.

    Within a batch the order of the candidates does not matter: the dedup
    sorts on (diagonal, rs, length, score), and rows equal on that key are
    the same HSP."""
    out = []
    for b in np.unique(rows[:, 8]):
        r = rows[rows[:, 8] == b]
        hsps = finalize_batch(r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 4:8],
                              hspthresh=hspthresh, noentropy=noentropy,
                              rm_mode=rm_mode, rev=rev, ref_len=ref_len)
        if hsps is not None:
            out.append(hsps)
    return np.concatenate(out) if out else np.zeros((0, 4), np.int64)


class ShardedAligner:
    """MultiDeviceAligner's interface over the sharded seed table (the
    CLIs' --sharded_table). It has one route and seeds on the device: the
    host seeder reads the whole table.

    group: None keeps every shard in this process; a torch.distributed
    process group spreads them over its ranks, `num_devices` shards a rank
    (shard_devices), S = world size x that, a power of two. Every rank of
    the group must then call set_ref, set_query and map_chunks with the
    same arguments in the same order, and each gets the same results."""

    def __init__(self, *, device, num_devices: int = -1, shape_pos,
                 seed_size, transition, step, sub_mat, xdrop, hspthresh,
                 noentropy, chunk_size, max_hits: int = DEFAULT_MAX_HITS,
                 HBUF: int = 1 << 17, rm_mode: bool = False, group=None):
        rank, world = _rank_world(group)
        self.group = group
        self.devices = shard_devices(device, num_devices, world)
        # this process's shards are global shards first .. first + S_local
        self.first = rank * len(self.devices)
        self.S = S = world * len(self.devices)
        if S & (S - 1):
            raise ValueError(f"--sharded_table needs a power of two of "
                             f"shards; {world} processes x "
                             f"{len(self.devices)} make {S}")
        self.shape_pos = tuple(shape_pos)
        self.kmer_size = len(shape_pos)
        self.seed_size = seed_size
        self.transition = transition
        self.step = step
        self.xdrop = xdrop
        self.hspthresh = hspthresh
        self.noentropy = noentropy
        self.max_hits = max_hits
        self.HBUF = HBUF
        self.rm_mode = rm_mode
        # each shard seeds chunk_loc positions of a chunk
        self.chunk_loc = -(-chunk_size // S)
        self.shift = 2 * self.kmer_size - (S.bit_length() - 1)
        sub = torch.as_tensor(np.asarray(sub_mat, np.int32).reshape(-1))
        # what every shard of a device reads: sub now, the padded sequences
        # from set_ref and set_query
        self._shared = {d: {"sub": sub.to(d)} for d in set(self.devices)}
        self.ref_len = 0
        self.q_len = 0
        # whether the collectives copy a card's tensors through host memory
        self.host_staged = group is not None and any(
            d.type == "cuda" and comm_device(group, d).type == "cpu"
            for d in self.devices)

    @property
    def num_devices(self) -> int:
        """The shards of the whole group."""
        return self.S

    def _replicate(self, name: str, codes: np.ndarray, right_pad: int = 0):
        padded = torch.from_numpy(pad_sequence(codes, PAD, right_pad))
        for d, shared in self._shared.items():
            shared[name] = padded.to(d)

    def set_ref(self, ref_codes: np.ndarray, tables=None):
        self.ref_len = len(ref_codes)
        if tables is None:
            tables = build_seed_table(ref_codes, self.step, self.shape_pos,
                                      self.seed_size, self.kmer_size)
        ish, psh = shard_seed_table(*tables, self.S)
        mine = range(self.first, self.first + len(self.devices))
        self.index_shards = [torch.from_numpy(ish[g]).to(d)
                             for g, d in zip(mine, self.devices)]
        # a shard's own positions, without the padding to the widest shard
        # (one element at least: expand_hits indexes the table even with no
        # hits)
        self.pos_shards = [
            torch.from_numpy(psh[g, :max(int(ish[g, -1]), 1)].copy()).to(d)
            for g, d in zip(mine, self.devices)]
        self._replicate("ref", ref_codes)

    def set_query(self, fw_codes: np.ndarray, rc_codes: np.ndarray):
        self.q_len = len(fw_codes)
        # the last shard's slice of a chunk at the end of the query reads
        # up to S * chunk_loc + seed_size bytes past the chunk's start
        right = self.S * self.chunk_loc + self.seed_size + 1
        self._replicate("q_fw", fw_codes, right)
        self._replicate("q_rc", rc_codes, right)

    def map_chunks(self, work, depth: int = 4) -> List[ChunkResult]:
        """Chunks in order, results in work order (`depth` is the farm's
        argument and has no meaning here)."""
        return [self.seed_and_filter(w.chunk_start, w.chunk_end, w.rev,
                                     window=w.window) for w in work]

    def seed_and_filter(self, chunk_start: int, chunk_end: int, rev: bool,
                        window: Optional[Tuple[int, int]] = None
                        ) -> ChunkResult:
        """The HSPs of one chunk-strand. window: the RM window (lo, hi) of
        reference positions a hit must lie in, or None."""
        S, loc, devices = self.S, self.chunk_loc, self.devices
        group = self.group
        qname = "q_rc" if rev else "q_fw"
        empty = np.zeros((0, 4), np.int64)
        nloc = loc * (1 + self.kmer_size if self.transition else 1)

        # 1-2. each shard's seeds, grouped by owner, with their global slots
        send, sizes, orders = [], [], []
        for s, dev in enumerate(devices, self.first):
            with on_device(dev):
                my_len = min(max(chunk_end - chunk_start - s * loc, 0), loc)
                kmers, qpos, valid = chunk_kmers(
                    self._shared[dev][qname], chunk_start + s * loc, my_len,
                    CHUNK=loc, seed_size=self.seed_size,
                    shape_pos=self.shape_pos, transition=self.transition,
                    pad=PAD)
                owner = torch.where(valid, kmers >> self.shift, S)
                order = torch.argsort(owner, stable=True)
                counts = torch.bincount(owner, minlength=S + 1)[:S].tolist()
                order = order[:sum(counts)]   # invalid slots sort last
                send.append(torch.stack([
                    kmers[order], qpos[order],
                    (s * nloc + order).to(torch.int32)]))
                sizes.append(counts)
                orders.append(order)
        if group is not None:
            # the S x S size matrix of the whole group: the splits of both
            # exchanges, and num_seeds the same on every rank
            sizes = _all_gather(torch.tensor(sizes, dtype=torch.int64,
                                             device=comm_device(
                                                 group, devices[0])),
                                group).tolist()
        num_seeds = sum(map(sum, sizes))
        if num_seeds == 0:
            return ChunkResult(empty, 0, 0)
        recv = exchange(send, sizes, devices, group)

        # 3. the owners' hit counts from their slices of the index table
        local = []
        for d, dev in enumerate(devices):
            with on_device(dev):
                rk, rq, rslot = recv[d]
                index = self.index_shards[d]
                starts, ends = bucket_ranges(index, rk & (index.numel() - 1))
                local.append((starts, ends - starts, rq, rslot))

        # 4. the counts back in slot order, their global cumsum and the
        # batch limits of the replicated device route
        back = exchange([c[None] for _, c, _, _ in local],
                        [list(col) for col in zip(*sizes)], devices, group)
        slot_counts = []
        for s, dev in enumerate(devices):
            with on_device(dev):
                c = torch.zeros(nloc, dtype=torch.int32, device=dev)
                c[orders[s]] = back[s][0]
                slot_counts.append(c)
        counts_all = gather_to(slot_counts, devices[0], group)
        num_hits = int(counts_all.sum(dtype=torch.int64))
        check_chunk_hits(num_hits, chunk_start, int32_cum=True)
        cum = torch.cumsum(counts_all, 0, dtype=torch.int32)
        if num_hits == 0:
            return ChunkResult(empty, 0, num_seeds)
        limit_slots, _ = _batch_limits(cum, num_hits, self.max_hits)
        limit_slots = torch.tensor(limit_slots, dtype=torch.int32)

        # 5-6. expansion and extension on each shard; candidates to the host
        # (of every rank: a rank without rows joins with none)
        rows = [torch.zeros((0, 9), dtype=torch.int64, device=devices[0])]
        for d, dev in enumerate(devices):
            starts, counts, rq, rslot = local[d]
            if counts.numel() == 0:
                continue
            shared = self._shared[dev]
            with on_device(dev):
                cum_d = torch.cumsum(counts, 0, dtype=torch.int32)
                # a seed's batch: the number of limits below its slot
                seed_batch = torch.searchsorted(limit_slots.to(dev), rslot)
                n_d = int(cum_d[-1])
                for g0 in range(0, n_d, self.HBUF):
                    g1 = min(g0 + self.HBUF, n_d)
                    ref_loc, query_loc, valid, seed = expand_hits(
                        cum_d, starts, rq, self.pos_shards[d], g0, g1,
                        self.seed_size, HBUF=g1 - g0, with_seed=True)
                    if window is not None:
                        valid &= ((ref_loc >= window[0])
                                  & (ref_loc <= window[1]))
                    res = extend_hits_windowed(
                        shared["ref"], shared[qname], ref_loc, query_loc,
                        valid, shared["sub"], self.xdrop, self.hspthresh,
                        self.ref_len, self.q_len, pad=PAD, W=PAD)
                    sel = torch.nonzero(res["candidate"]).squeeze(1)
                    batch = seed_batch[seed.long()[sel]].to(torch.int32)
                    rows.append(torch.cat(
                        [res[k][sel, None]
                         for k in ("rs", "qs", "length", "total")]
                        + [res["counts"][sel], batch[:, None]],
                        dim=1).long())
        hsps = finalize_sharded(
            gather_to(rows, "cpu", group).numpy(), hspthresh=self.hspthresh,
            noentropy=self.noentropy, rm_mode=self.rm_mode, rev=rev,
            ref_len=self.ref_len)
        return ChunkResult(hsps, num_hits, num_seeds)
