"""Windowed x-drop extension in plain PyTorch: the port's CPU engine and
the oracle of every scan kernel.

Counterpart of segalign_tpu/ops/extend3.py. window_step has the semantics
of _extension_window_step_lean: gather one W-wide window per hit at offset
`tile` from its anchor, mask it to the sequence bounds, scan it, and update
the carried state of the rows still alive. scan_ext_window is the step
without the gather, on windows in extension order: the plain version of
the wide window kernel (ops/window_scan_wide.py). scan_raw_window takes
raw windows in storage order: the plain version of the continuation
kernel (ops/window_scan.py) and, at tile 0 from a fresh state, of each half
of the first-window kernel (ops/first_scan.py). scan_window is the scan
under all of them. extend_hits_windowed is the host-stepped engine of the
device-seeding route.

The state of one direction is a dict of tensors: done (B,) bool; cum,
maxv, maxp (B,) int32; counts, cdel (B, 4) int32. Everything is int32 with
int32 wraparound, as in the JAX package: every cumulative sum and count
names dtype=torch.int32 (torch would widen to int64 otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from .gather import gather_rows_plain

NEG = -(2**31) + 1
STATE_KEYS = ("done", "cum", "maxv", "maxp", "counts", "cdel")


def scan_window(r, q, p, inb, edge, st, sub, xdrop: int,
                with_counts: bool):
    """Scan one window for every row and return the new state.

    r, q: (B, W) codes in extension order (lane 0 is the first position
    the extension reaches); p: (1, W) extension offset of each lane;
    inb: (B, W) in-bounds mask; edge: (B,) the window reaches a sequence
    end. Rows done on entry keep their state."""
    W = r.shape[1]
    r = r.long()
    q = q.long()
    lanes = torch.arange(W, device=r.device)
    sc = torch.where(inb, sub[r * 8 + q], 0)
    cum = torch.cumsum(sc, dim=1, dtype=torch.int32) + st["cum"][:, None]
    run_max = torch.cummax(cum, dim=1).values
    m = torch.maximum(st["maxv"][:, None], run_max)
    drop = (m - cum) > xdrop
    anydrop = drop.any(dim=1)
    d = torch.where(drop, lanes, W).amin(dim=1)
    before = lanes < d[:, None]
    best = torch.where(before, cum, NEG).amax(dim=1)
    Mv = torch.maximum(st["maxv"], best)
    is_new = Mv > st["maxv"]
    # earliest lane holding the new max
    j = torch.where((cum == Mv[:, None]) & before, lanes, W).amin(dim=1)
    Mp = torch.where(is_new, p[0, j.clamp(max=W - 1)], st["maxp"])
    finish = anydrop | edge

    counts, cdel = st["counts"], st["cdel"]
    if with_counts:
        new_max = (Mp > st["maxp"])[:, None]
        counts = torch.where(new_max, counts + cdel, counts)
        cdel = torch.where(new_max, 0, cdel)
        match = inb & (r == q) & (r < 4)
        in_ext = p <= Mp[:, None]
        base = torch.arange(4, device=r.device)[None, None, :]
        onehot = (r[:, :, None] == base)
        counts = counts + ((match & in_ext)[:, :, None] & onehot).sum(
            dim=1, dtype=torch.int32)
        cdel = cdel + ((match & ~in_ext)[:, :, None] & onehot).sum(
            dim=1, dtype=torch.int32)

    alive = ~st["done"]
    al2 = alive[:, None]
    return dict(
        done=st["done"] | (alive & finish),
        cum=torch.where(alive, cum[:, -1], st["cum"]),
        maxv=torch.where(alive, Mv, st["maxv"]),
        maxp=torch.where(alive, Mp, st["maxp"]),
        counts=torch.where(al2, counts, st["counts"]),
        cdel=torch.where(al2, cdel, st["cdel"]))


def scan_ext_window(r, q, loc_r, loc_q, st, sub, xdrop: int, tile: int,
                    ref_len: int, query_len: int, *, W: int, left: bool,
                    with_counts: bool):
    """Scan (B, W) windows in extension order: lane k is extension offset
    tile + k to the right and tile + 1 + k to the left. The in-bounds mask
    and the edge test (the last lane is out of bounds) come from the
    anchors. Returns the new state dict."""
    lanes = torch.arange(W, device=r.device, dtype=torch.int32)
    if left:
        p = (tile + 1 + lanes)[None, :]
        inb = (loc_r[:, None] >= p) & (loc_q[:, None] >= p)
        edge = (loc_r < tile + W) | (loc_q < tile + W)
    else:
        p = (tile + lanes)[None, :]
        inb = ((loc_r[:, None] + p) < ref_len) & \
              ((loc_q[:, None] + p) < query_len)
        edge = (loc_r + tile + (W - 1) >= ref_len) | \
               (loc_q + tile + (W - 1) >= query_len)
    return scan_window(r, q, p, inb, edge, st, sub, xdrop, with_counts)


def scan_raw_window(r, q, loc_r, loc_q, st, sub, xdrop: int, tile: int,
                    ref_len: int, query_len: int, *, W: int, left: bool,
                    with_counts: bool):
    """Scan raw (B, W) windows in ascending storage order: [loc + tile,
    loc + tile + W) to the right, or [loc - tile - W, loc - tile) to the
    left, scanned from its last byte down (extension offset p = tile + W -
    f at storage lane f). Returns the new state dict."""
    if left:
        r, q = r.flip(1), q.flip(1)
    return scan_ext_window(r, q, loc_r, loc_q, st, sub, xdrop, tile,
                           ref_len, query_len, W=W, left=left,
                           with_counts=with_counts)


def window_step(seq_r_pad, seq_q_pad, loc_r, loc_q, tile: int, state, sub,
                xdrop: int, ref_len: int, query_len: int, *, pad: int,
                W: int, left: bool, with_counts: bool = True):
    """One W-wide window at offset `tile` for every row (plain torch).

    seq_*_pad: 1-D uint8 padded sequences (`pad` bytes before position 0);
    loc_r/loc_q: (B,) int32 anchors; state: the direction's state dict;
    sub: (64,) int32 substitution table. Returns the new state dict."""
    off = -tile - W if left else tile
    r = gather_rows_plain(seq_r_pad, pad + loc_r + off, W)
    q = gather_rows_plain(seq_q_pad, pad + loc_q + off, W)
    return scan_raw_window(r, q, loc_r, loc_q, state, sub, xdrop, tile,
                           ref_len, query_len, W=W, left=left,
                           with_counts=with_counts)


def check_tensors(args, device, W: int):
    """Raise unless every (name, tensor, dtype, shape) of `args` is a
    contiguous tensor of that dtype and shape on `device`, with byte rows
    16-byte aligned, and W a multiple of 16 in (0, 4096] (the scan kernels
    read rows in 16-byte loads and count in 16-bit fields)."""
    for name, t, dt, shape in args:
        # every scan launch runs these: `is not` on a dtype and Size
        # against a tuple are the cheap forms of the comparisons
        if t.dtype is not dt or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if dt is torch.uint8 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if W <= 0 or W % 16 or W > 4096:
        raise ValueError(f"W={W} must be a multiple of 16 in (0, 4096]")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def init_state(B: int, init_maxp: int, valid, device):
    """Fresh state of one direction: rows not valid start done."""
    z = torch.zeros(B, dtype=torch.int32, device=device)
    return dict(done=~valid, cum=z, maxv=z.clone(),
                maxp=torch.full((B,), init_maxp, dtype=torch.int32,
                                device=device),
                counts=torch.zeros((B, 4), dtype=torch.int32, device=device),
                cdel=torch.zeros((B, 4), dtype=torch.int32, device=device))


def finalize(valid, loc_r, loc_q, r_maxv, r_maxp, l_maxv, l_maxp, counts,
             hspthresh: int):
    """Per-hit extension fields (counterpart of extend3._finalize)."""
    total = r_maxv + l_maxv
    zero = torch.zeros_like(total)
    return dict(
        candidate=valid & (total >= hspthresh),
        rs=torch.where(valid, loc_r - l_maxp, zero),
        qs=torch.where(valid, loc_q - l_maxp, zero),
        length=torch.where(valid, r_maxp + l_maxp, -1),
        total=torch.where(valid, total, zero),
        counts=torch.where(valid[:, None], counts, 0))


def extend_hits_windowed(ref_pad, query_pad, ref_loc, query_loc, valid, sub,
                         xdrop: int, hspthresh: int, ref_len: int,
                         query_len: int, *, pad: int, W: int):
    """Extend every valid hit in both directions; the fields dict of
    finalize (counterpart of segalign_tpu's extend3.extend_hits_windowed).

    Each direction starts from a fresh state and steps W-wide windows at
    tile = k * W (a gather, then window_scan_wide) over the rows still
    alive, until none is. The right direction runs first, from maxp = -1
    and zero counts; the left one from maxp = 0 and the right direction's
    counts, which it finishes with. Counts are on: the route finalizes
    entropy from them. The JAX engine's CONT-row compaction is scheduling
    and has no counterpart (every step runs on the alive rows only)."""
    # imported here: extend_fused imports this module
    from .extend_fused import run_survivors
    B, dev = ref_loc.shape[0], ref_loc.device
    loc_r = torch.where(valid, ref_loc, 0)
    loc_q = torch.where(valid, query_loc, 0)
    kw = dict(pad=pad, tile=0, W=W, with_counts=True, wide=True)
    st_r = run_survivors(ref_pad, query_pad, loc_r, loc_q,
                         init_state(B, -1, valid, dev), sub, xdrop, ref_len,
                         query_len, left=False, **kw)
    st_l = init_state(B, 0, valid, dev)
    st_l["counts"] = st_r["counts"].clone()
    st_l = run_survivors(ref_pad, query_pad, loc_r, loc_q, st_l, sub, xdrop,
                         ref_len, query_len, left=True, **kw)
    return finalize(valid, loc_r, loc_q, st_r["maxv"], st_r["maxp"],
                    st_l["maxv"], st_l["maxp"], st_l["counts"], hspthresh)


def state_from_numpy(st, device="cpu"):
    """The JAX package's state dict (numpy arrays) as the port's."""
    out = {}
    for k in STATE_KEYS:
        a = np.asarray(st[k])
        dt = torch.bool if k == "done" else torch.int32
        out[k] = torch.from_numpy(np.ascontiguousarray(
            a.astype(bool if k == "done" else np.int32))).to(device, dt)
    return out


def state_to_numpy(st):
    """The port's state dict as numpy arrays."""
    return {k: st[k].cpu().numpy() for k in STATE_KEYS}
