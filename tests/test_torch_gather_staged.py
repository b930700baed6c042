"""The decompositions of the staged gathers (csrc/gather.cu K3,
csrc/gather_variants.cu S1) are exact: numpy models of what the kernels do,
against the plain versions, zero tolerance.

K3 (tile_gather below): tiles of 128 rows; the tile's clamped starts and
their least and greatest (four warps of 32, then four words); the span
rounded to 16 bytes on the absolute address, clipped to the aligned bytes
the sequence holds and capped at min(T x 128, 96 KB); a row that lies
inside the staged bytes is cut from them, 16 output bytes from two aligned
16-byte words and a funnel shift (cut16), any other row reads the sequence
directly in the same form, with single bytes where an aligned word would
reach past an end of the sequence; W that is not a multiple of 16 takes
both routes in 4-byte words. The model's memory is a buffer with the
sequence `m` bytes past a 16-byte boundary, and every read outside the
sequence, or from a staged byte that was never copied, raises.

S1 (variant_gather below): a bank row is W + 16 bytes, the aligned cover of
the window from starts[i] & ~15 (double-buffered; zeros in extract only),
or the W bytes at the row's 1024-aligned address (load only); rows are cut
with cut16 at starts[i] % 16.

Nothing on the port's paths calls these models."""

import numpy as np
import pytest
import torch

from segalign_tpu_torch.ops.gather import (MAX_T, TILE_ROWS,
                                           gather_rows_plain,
                                           gather_rows_tile, tile_spans_ok)
from segalign_tpu_torch.ops.gather_variants import (
    awin_for, gather_dbuf_plain, gather_dma_only_plain,
    gather_extract_only_plain)

MAX_STAGE = 96 * 1024   # kMaxStage of csrc/gather.cu
U32 = np.uint32


def funnelshift_r(lo, hi, sh):
    """The low 32 bits of (hi:lo) >> sh, as the hardware's shf.r.wrap."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both >> np.uint64(sh)) & np.uint64(0xffffffff)).astype(U32)


def cut16(lo, hi, off):
    """(n, 4) uint32 words lo and hi -> bytes [off, off + 16) of lo | hi,
    with the kernel's case split on off >> 2."""
    x = np.concatenate([lo, hi], axis=1)
    k, sh = off >> 2, 8 * (off & 3)
    return np.stack([funnelshift_r(x[:, k + j], x[:, k + j + 1], sh)
                     for j in range(4)], axis=1)


class Memory:
    """A byte buffer whose index 0 is a 16-byte boundary, with the sequence
    at [m, m + L); reads outside the sequence raise."""

    def __init__(self, seq, m):
        self.m, self.L = m, len(seq)
        self.buf = np.full(m + len(seq) + 64, 0xEE, np.uint8)
        self.buf[m:m + len(seq)] = seq

    def read(self, x, n):
        assert self.m <= x and x + n <= self.m + self.L, (x, n)
        return self.buf[x:x + n]

    def words16(self, x0, count):
        """`count` aligned 16-byte words from x0 as (count, 4) uint32."""
        assert x0 % 16 == 0
        return self.read(x0, 16 * count).view(U32).reshape(count, 4)


def tile_span(s, W, m, L, cap):
    """The kernel's tile_span from the clamped starts of one tile."""
    pad = np.concatenate([s, np.full(-len(s) % 32, s[0], s.dtype)])
    wlo = pad.reshape(-1, 32).min(axis=1)
    whi = pad.reshape(-1, 32).max(axis=1)
    lo, hi = int(wlo.min()), int(whi.max())
    a = max((lo + m) & ~15, (m + 15) & ~15)
    b = min((hi + W + m + 15) & ~15, (L + m) & ~15)
    return a, min(max(b - a, 0), cap)


def direct16(mem, p, count):
    """`count` units of 16 bytes from offset p of the sequence, as the
    kernel's direct16 reads them."""
    out = np.empty((count, 4), U32)
    for u in range(count):
        x = p + 16 * u + mem.m
        x0, off = x & ~15, x & 15
        if x0 >= mem.m and x0 + (32 if off else 16) <= mem.m + mem.L:
            lo = mem.words16(x0, 1)
            hi = mem.words16(x0 + 16, 1) if off else lo
            out[u] = cut16(lo, hi, off)[0]
        else:
            out[u] = mem.read(x, 16).view(U32)
    return out


def tile_gather(seq, starts, W, T, m=0):
    """(out, rows that read the sequence directly) of the K3 model."""
    mem = Memory(seq, m)
    L, B = len(seq), len(starts)
    cap = min(T * 128, MAX_STAGE)
    out = np.zeros((B, W), np.uint8)
    n_direct = 0
    for row0 in range(0, B, TILE_ROWS):
        s = np.clip(starts[row0:row0 + TILE_ROWS].astype(np.int64), 0, L - W)
        a, n = tile_span(s, W, m, L, cap)
        # the stage: n copied bytes, then bytes nobody may use
        stage = np.full(cap + 16, 0xDD, np.uint8)
        copied = np.zeros(cap + 16, bool)
        if n:
            assert a % 16 == 0 and n % 16 == 0
            stage[:n] = mem.read(a, n)
            copied[:n] = True
        for r, sr in enumerate(s):
            off = int(sr) + m - a
            fits = off >= 0 and off + W <= n
            n_direct += not fits
            if W % 16 == 0:
                units = W // 16
                if fits:
                    w16 = stage.view(U32).reshape(-1, 4)
                    q = off >> 4
                    # the word past the row is read but, at off % 16 == 0,
                    # not used
                    assert copied[off:off + W].all()
                    row = cut16(w16[q:q + units], w16[q + 1:q + 1 + units],
                                off & 15)
                else:
                    row = direct16(mem, int(sr), units)
            else:
                words = W // 4
                if fits:
                    assert copied[off:off + W].all()
                    w4 = stage.view(U32)
                    q = off >> 2
                    row = funnelshift_r(w4[q:q + words],
                                        w4[q + 1:q + 1 + words],
                                        8 * (off & 3))
                else:
                    row = mem.read(int(sr) + m, W).view(U32)
            out[row0 + r] = np.ascontiguousarray(row).view(np.uint8).reshape(
                -1)
    return out, n_direct


def _plain(seq, starts, W):
    return gather_rows_plain(torch.from_numpy(seq), torch.from_numpy(starts),
                             W).numpy()


def _seq(rng, L):
    return rng.integers(0, 256, L).astype(np.uint8)


def _clustered(rng, B, L, W, width):
    """Tiles whose windows fit `width` bytes, at random places."""
    tiles = -(-B // TILE_ROWS)
    base = rng.integers(0, max(L - width, 1), tiles)
    s = np.repeat(base, TILE_ROWS)[:B] + rng.integers(
        0, max(width - W, 1), B)
    return s.astype(np.int32)


@pytest.mark.parametrize("m", [0, 1, 15])
@pytest.mark.parametrize("W", [4, 8, 12, 16, 20, 48, 1024, 2048])
@pytest.mark.parametrize("kind", ["clustered", "unclustered", "clamped"])
def test_tile_model_equals_plain(kind, W, m):
    """Every W the wrapper admits in kind (4-byte and 16-byte routes), a
    sequence on and off a 16-byte boundary; starts that cluster, that do
    not (every row reads directly), and that lie below 0 and above L - W
    (the clamp), with a length that is not a multiple of 16."""
    rng = np.random.default_rng([W, m, len(kind)])
    L, B, T = 40_003 + 13 * W, 300, 64
    seq = _seq(rng, L)
    if kind == "clustered":
        starts = _clustered(rng, B, L, W, T * 128 - 32)
    elif kind == "unclustered":
        starts = rng.integers(0, L - W, B).astype(np.int32)
        starts[::TILE_ROWS] = 0
        starts[1::TILE_ROWS] = L - W
    else:
        starts = rng.integers(-3000, L + 3000, B).astype(np.int32)
        starts[:4] = [-1, -2**31, 2**31 - 1, L - W + 1]
        starts[130:134] = [0, L - W, L - W - 1, 1]
    got, n_direct = tile_gather(seq, starts, W, T, m)
    np.testing.assert_array_equal(got, _plain(seq, starts, W))
    if kind == "clustered" and W <= T * 128 - 32:
        # whole tiles staged, but for rows at the sequence's first bytes
        assert n_direct <= (starts + m < 16).sum()
        assert tile_spans_ok(starts, W, T)
    if kind == "unclustered":
        assert n_direct > B // 2 and not tile_spans_ok(starts, W, T)


@pytest.mark.parametrize("m", [0, 5])
@pytest.mark.parametrize("lo_mod", [0, 1, 15])
@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("T", [1, 9, 64])
def test_tile_model_span_at_the_cap(T, delta, lo_mod, m):
    """A tile whose span is exactly T x 128 bytes, one under and one over,
    from an aligned and an unaligned first byte: rounding the span to 16
    bytes can push the last rows out of the stage, and the output is the
    same."""
    rng = np.random.default_rng([T, delta + 1, lo_mod, m])
    W = 64 if T > 1 else 16
    L = 50_000
    seq = _seq(rng, L)
    lo = 4096 + lo_mod
    hi = lo + T * 128 - W + delta            # span = hi + W - lo
    s = rng.integers(lo, hi + 1, TILE_ROWS)
    s[[3, 77]] = [hi, lo]
    # a second tile, far away, so that the two stages differ
    starts = np.concatenate([s, s[::-1] + 20_000, s[:5]]).astype(np.int32)
    got, n_direct = tile_gather(seq, starts, W, T, m)
    np.testing.assert_array_equal(got, _plain(seq, starts, W))
    assert tile_spans_ok(starts, W, T) == (delta <= 0)
    # the stage starts (lo + m) % 16 bytes below the span and is T x 128
    # bytes long: rows are pushed out of it exactly when that overflows
    assert (n_direct > 0) == ((lo + m) % 16 + delta > 0)


@pytest.mark.parametrize("B", [0, 1, 31, 33, 127, 128, 129, 257])
def test_tile_model_ragged_batches(B):
    rng = np.random.default_rng(B)
    L, W, T = 30_000, 32, 16
    seq = _seq(rng, L)
    starts = _clustered(rng, B, L, W, T * 128 - 32)
    got, _ = tile_gather(seq, starts, W, T, 3)
    assert got.shape == (B, W)
    np.testing.assert_array_equal(got, _plain(seq, starts, W))


@pytest.mark.parametrize("T", [1, 64, 512, 768, 769, MAX_T])
def test_tile_model_every_stage_size(T):
    """T up to the wrapper's limit: above 768 the stage is capped at 96 KB
    and rows past it read directly."""
    rng = np.random.default_rng(T)
    L, W, B = 300_000, 1024, 256
    seq = _seq(rng, L)
    width = max(T * 128 - 32, W + 1)
    starts = _clustered(rng, B, L, W, width)
    starts[1] = starts[:TILE_ROWS].min() + width - W   # the span's last row
    got, n_direct = tile_gather(seq, starts, W, T)
    np.testing.assert_array_equal(got, _plain(seq, starts, W))
    if T * 128 - 32 < W:
        assert n_direct == B                 # no window fits a stage
    elif T <= 768:
        assert n_direct == 0
    else:
        assert 0 < n_direct < B


@pytest.mark.parametrize("m", [0, 1, 8, 15])
@pytest.mark.parametrize("L", [16, 17, 31, 32, 33, 64, 100])
def test_tile_model_short_sequences(L, m):
    """Sequences of a few 16-byte words: the clipped stage can be empty,
    and every read stays inside the sequence."""
    rng = np.random.default_rng([L, m])
    seq = _seq(rng, L)
    for W in (4, 16):
        starts = rng.integers(-5, L + 5, 140).astype(np.int32)
        got, _ = tile_gather(seq, starts, W, 1, m)
        np.testing.assert_array_equal(got, _plain(seq, starts, W))


def test_tile_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors gather_rows_tile takes the plain version, counts no
    launch, for a view one byte off its storage's start too."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(_seq(rng, 20_001))
    starts = torch.from_numpy(rng.integers(-50, 21_000, 300).astype(np.int32))
    before = gather_rows_tile.launches, dict(gather_rows_tile.launches_by_T)
    for seq in (base, base[1:]):
        for W, T in ((20, 1), (1024, 64), (2048, MAX_T)):
            assert torch.equal(gather_rows_tile(seq, starts, W, T),
                               gather_rows_plain(seq, starts, W))
    assert (gather_rows_tile.launches,
            gather_rows_tile.launches_by_T) == before
    with pytest.raises(ValueError, match="T="):
        gather_rows_tile(base, starts, 16, MAX_T + 1)


# ---- S1

ROWS = {"dma_only": 16, "extract_only": 16, "dbuf": 8}   # kRows


def variant_gather(seq, starts, W, mode):
    """The S1 model: row blocks of ROWS rows through a bank of W + 16 byte
    rows; the sequence lies on a 16-byte boundary."""
    mem = Memory(seq, 0)
    B, stride = len(starts), W + 16
    out = np.zeros((B, W), np.uint8)
    for row0 in range(0, B, ROWS[mode]):
        blk = starts[row0:row0 + ROWS[mode]].astype(np.int64)
        bank = np.full(ROWS[mode] * stride, 0xDD, np.uint8)
        for r, s in enumerate(blk):
            row = bank[r * stride:(r + 1) * stride]
            if mode == "dma_only":
                row[:W] = mem.read((s // 1024) * 1024, W)
            elif mode == "dbuf":
                row[:] = mem.read(s & ~15, W + 16)
            else:
                row[:] = 0
        for r, s in enumerate(blk):
            w16 = bank[r * stride:(r + 1) * stride].view(U32).reshape(-1, 4)
            units = W // 16
            if mode == "dma_only":
                row = w16[:units]
            else:
                row = cut16(w16[:units], w16[1:units + 1], int(s & 15))
            out[row0 + r] = np.ascontiguousarray(row).view(np.uint8).reshape(
                -1)
    return out


@pytest.mark.parametrize("W", [16, 128, 512, 2048])
@pytest.mark.parametrize("mode", ["dma_only", "extract_only", "dbuf"])
def test_variant_model_equals_plain(mode, W):
    """Starts at offsets 0, 1, 15, 16 and 1023 of a 1024-byte slice and at
    both ends of the range the wrappers admit, [0, len(seq) - awin_for(W)];
    B not a multiple of a bank's rows."""
    rng = np.random.default_rng([W, len(mode)])
    L = 9000 + awin_for(W)
    hi = L - awin_for(W)
    seq = _seq(rng, L)
    starts = rng.integers(0, hi + 1, 203).astype(np.int32)
    edges = [0, 1, 15, 16, 1023, 1024, 2048 + 15, 4096 + 1023, hi, hi - 1,
             hi - 15, hi - 16]
    starts[:len(edges)] = edges
    plain = dict(dma_only=gather_dma_only_plain,
                 extract_only=gather_extract_only_plain,
                 dbuf=gather_dbuf_plain)[mode]
    want = plain(torch.from_numpy(seq), torch.from_numpy(starts), W).numpy()
    np.testing.assert_array_equal(variant_gather(seq, starts, W, mode), want)
    if mode == "extract_only":
        assert not want.any()


@pytest.mark.parametrize("off", range(16))
def test_cut16_every_offset(off):
    rng = np.random.default_rng(off)
    raw = rng.integers(0, 256, (7, 32)).astype(np.uint8)
    words = raw.view(U32)
    got = cut16(words[:, :4], words[:, 4:], off).view(np.uint8)
    np.testing.assert_array_equal(got, raw[:, off:off + 16])
