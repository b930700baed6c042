"""A numpy model of csrc/first_scan.cu's first_scan_seq_kernel (K1 on the
padded sequences), step for step as the kernel walks: one (row,
direction) a thread, the warp's 32 rows together.

- Each row's window is read as the aligned 16-byte blocks of r that hold
  its in-bounds lanes; lane 0 sits at walk position mr of block 0, and the
  positions before it and past the last in-bounds lane are masked.
- The q bytes of each r block are cut from two aligned q blocks by two
  word selects and four funnel shifts (align_block), at any of the 16
  byte offsets; blocks read past either end of a sequence read as 0.
- The warp runs the full recurrence until no row of it has an alive lane
  left (a vote after each block), then only the sums; a block that holds
  a masked lane of any row of the warp takes the masked step.
- The best (the largest cum before the drop, strict >) is kept apart
  from the running max, so that any xdrop, a negative one too, holds.
- The match counts run in 8-bit fields a block, flushed into 16-bit
  fields, with a snapshot at each new best: counts and cdel come out of
  the one walk.

k1s_model returns the two states (right, left) as first_scan_seq does, and
for each direction the block at which each warp left the full recurrence.
"""

from __future__ import annotations

import numpy as np

NEG = -(2**31) + 1
BIG = 1 << 30


def align_block(lo: np.ndarray, hi: np.ndarray, d: np.ndarray) -> np.ndarray:
    """csrc/first_scan.cu align_block on rows of words: lo, hi (R, 4)
    uint32, d (R,) in [0, 16) -> (R, 4) uint32, bytes [d, d + 16) of lo:hi."""
    w = np.concatenate([lo, hi], axis=1).astype(np.uint64)
    w8 = (d & 8) != 0
    w4 = (d & 4) != 0
    u = np.where(w8[:, None], w[:, 2:8], w[:, 0:6])
    v = np.where(w4[:, None], u[:, 1:6], u[:, 0:5])
    sh = (8 * (d & 3)).astype(np.uint64)[:, None]
    pair = v[:, :4] | (v[:, 1:5] << np.uint64(32))
    return ((pair >> sh) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def load_block(seq: np.ndarray, off: np.ndarray) -> np.ndarray:
    """The aligned 16-byte blocks at offsets off (R,) of seq as (R, 4)
    uint32 words; bytes outside [0, len(seq)) read as 0."""
    idx = off[:, None] + np.arange(16)[None, :]
    inside = (idx >= 0) & (idx < len(seq))
    b = np.where(inside, seq[np.clip(idx, 0, len(seq) - 1)], 0)
    return np.ascontiguousarray(b.astype(np.uint8)).view("<u4").reshape(-1, 4)


def window_start(pad: int, loc: np.ndarray, W: int, n: int) -> np.ndarray:
    """pad + loc - W wrapped to int32, clamped to [0, n - 2W]."""
    s = (pad + loc.astype(np.int64) - W + 2**31) % 2**32 - 2**31
    return np.clip(s, 0, n - 2 * W)


def _match_fields(idx: np.ndarray) -> np.ndarray:
    """1 << (8 b) where the pair is a match of base b < 4, else 0."""
    base = idx // 9
    return np.where((idx % 9 == 0) & (idx < 32),
                    np.left_shift(np.uint32(1), (8 * base).astype(np.uint32)),
                    np.uint32(0)).astype(np.uint32)


def _direction(ref, qry, lr, lq, ok, sub, xdrop, ref_len, query_len, pad, W,
               counts, left):
    R = len(lr)                      # a multiple of 32
    lim = np.minimum(lr, lq) if left else np.minimum(ref_len - lr,
                                                     query_len - lq)
    kend = np.where(~ok | (lim <= 0), 0, np.minimum(lim, W)).astype(np.int64)
    fr = window_start(pad, lr, W, len(ref)) + (W - 1 if left else W)
    fq = window_start(pad, lq, W, len(qry)) + (W - 1 if left else W)
    mr = 15 - (fr & 15) if left else fr & 15
    step = -16 if left else 16
    r_off = fr & ~15
    t = fq - 15 + mr if left else fq - mr
    d = t & 15
    q_off = (t & ~15) + (16 if left else 0)
    nb = np.where(kend > 0, (mr + kend + 15) >> 4, 0)

    warps = R // 32
    wv = lambda a: a.reshape(warps, 32)
    act = wv(kend > 0)
    nbw = wv(nb).max(1)
    i_lo = np.where((act & wv(mr > 0)).any(1), 1, 0)
    i_hi = np.where(act, wv((mr + kend) >> 4), BIG).min(1)
    rowwarp = np.repeat(np.arange(warps), 32)

    cum = np.zeros(R, np.int32)
    m = np.zeros(R, np.int32)
    best = np.full(R, NEG, np.int32)
    bestk = np.full(R, -1, np.int64)
    alive = np.ones(R, bool)
    lo = np.zeros(R, np.uint32)
    hi = np.zeros(R, np.uint32)
    snap_lo = np.zeros(R, np.uint32)
    snap_hi = np.zeros(R, np.uint32)
    full = np.ones(warps, bool)            # the warp's phase
    switched = np.full(warps, -1)          # the block after its last vote
    qprev = np.where((nb > 0)[:, None], load_block(qry, q_off), 0)
    q_off = q_off + step
    offs = np.zeros((R, 16), np.int64)
    sub = sub.astype(np.int32)
    xd = np.int32(xdrop) if -2**31 <= xdrop < 2**31 else None
    for i in range(int(nbw.max(initial=0))):
        walking = (i < nbw)[rowwarp]
        loads = i < nb
        rb = load_block(ref, r_off)
        qn = load_block(qry, q_off)
        r_off = np.where(loads, r_off + step, r_off)
        q_off = np.where(loads, q_off + step, q_off)
        qa = np.where(left, align_block(qn, qprev, d),
                      align_block(qprev, qn, d))
        qprev = np.where(loads[:, None], qn, qprev)
        rbytes = rb.view(np.uint8).reshape(R, 16).astype(np.int64)
        qbytes = qa.view(np.uint8).reshape(R, 16).astype(np.int64)
        offs = np.where(loads[:, None], (rbytes * 8 + qbytes) & 63, offs)
        plain = ((i >= i_lo) & (i < i_hi))[rowwarp]
        fullrow = full[rowwarp] & walking
        k0 = 16 * i - mr
        n = np.zeros(R, np.uint32)
        nsnap = np.zeros(R, np.uint32)
        snapped = np.zeros(R, bool)
        for jj in range(16):
            j = 15 - jj if left else jj
            idx = offs[:, j]
            s = sub[idx]
            one = _match_fields(idx) if counts else np.zeros(R, np.uint32)
            k = k0 + jj
            inl = plain | ((k >= 0) & (k < kend))
            s = np.where(inl & walking, s, 0).astype(np.int32)
            one = np.where(inl & walking, one, 0).astype(np.uint32)
            c = (cum + s).astype(np.int32)
            cum = c
            n = (n + one).astype(np.uint32)
            m = np.where(fullrow, np.maximum(m, c), m)
            drop = inl & ((m - c).astype(np.int32) > xd)
            alive = np.where(fullrow, alive & ~drop, alive)
            up = fullrow & alive & inl & (c > best)
            best = np.where(up, c, best)
            bestk = np.where(up, k, bestk)
            nsnap = np.where(up, n, nsnap)
            snapped |= up
        if counts:
            take = snapped & fullrow
            snap_lo = np.where(take, lo + (nsnap & 0x00FF00FF), snap_lo)
            snap_hi = np.where(take, hi + ((nsnap >> 8) & 0x00FF00FF),
                               snap_hi)
            lo = (lo + np.where(walking, n & 0x00FF00FF, 0)).astype(np.uint32)
            hi = (hi + np.where(walking, (n >> 8) & 0x00FF00FF, 0)
                  ).astype(np.uint32)
        vote = wv(alive & (k0 + 16 < kend)).any(1)
        leave = full & (i < nbw) & ~vote
        switched = np.where(leave, i + 1, switched)
        full = full & ~leave

    p0 = 1 if left else 0
    is_new = (kend > 0) & (best > 0)
    in_lo = np.where(is_new & counts, snap_lo, 0).astype(np.uint32)
    in_hi = np.where(is_new & counts, snap_hi, 0).astype(np.uint32)
    all_lo = np.where((kend > 0) & counts, lo, 0).astype(np.uint32)
    all_hi = np.where((kend > 0) & counts, hi, 0).astype(np.uint32)
    del_lo, del_hi = all_lo - in_lo, all_hi - in_hi
    fields = lambda a, b: np.stack(
        [a & 0xFFFF, b & 0xFFFF, a >> 16, b >> 16], 1).astype(np.int32)
    st = dict(done=(kend == 0) | ~alive | (kend < W),
              cum=np.where(kend > 0, cum, 0).astype(np.int32),
              maxv=np.where(is_new, best, 0).astype(np.int32),
              maxp=np.where(is_new, p0 + bestk, p0 - 1).astype(np.int32),
              counts=fields(in_lo, in_hi), cdel=fields(del_lo, del_hi))
    return st, switched


def k1s_model(ref_pad, query_pad, loc_r, loc_q, valid, sub, xdrop: int,
              ref_len: int, query_len: int, *, pad: int, W: int,
              with_counts: bool):
    """((st_right, st_left), (switched_right, switched_left)): the states
    as first_scan_seq gives them (numpy), and for each direction and warp
    the block after which the warp ran only the sums (-1 if it never
    left the full recurrence)."""
    ref = np.asarray(ref_pad, np.uint8)
    qry = np.asarray(query_pad, np.uint8)
    B = len(loc_r)
    R = -(-B // 32) * 32              # rows past B: threads with no row
    grow = lambda a, fill: np.concatenate(
        [np.asarray(a), np.full(R - B, fill, np.asarray(a).dtype)])
    lr = grow(loc_r, 0).astype(np.int64)
    lq = grow(loc_q, 0).astype(np.int64)
    ok = grow(valid, False).astype(bool)
    sub = np.asarray(sub, np.int64).astype(np.int32)
    outs, sw = [], []
    for left in (False, True):
        st, s = _direction(ref, qry, lr, lq, ok, sub, xdrop, ref_len,
                           query_len, pad, W, with_counts, left)
        outs.append({k: v[:B] for k, v in st.items()})
        sw.append(s)
    return tuple(outs), tuple(sw)
