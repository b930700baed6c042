"""ctypes bindings for the native host runtime (seeder, seed table, dedup,
entropy counts, gapped extension: native.cpp, seeder.cpp, gapped.cpp).

The library is built by _build.native_lib_path() with portable flags into
build/segalign_tpu_torch/ and loaded from there at first use. A failed
build or load raises: the port keeps no numpy version of these to fall
back to.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import _build

_lock = threading.Lock()
_lib = None


def _bind(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    for name in ("dedup_pairwise", "dedup_rm"):
        fn = getattr(lib, name)
        fn.argtypes = [i64p, i64p, i64p, i64p, i64]
        fn.restype = i64
    for name in ("encode_bytes", "revcomp_codes"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, u8p, i64]
        fn.restype = None
    lib.gapped_extend.argtypes = [u8p, i64, u8p, i64, i64p, i64, i64, i64,
                                  i64, i64, u8p, i64, i64p]
    lib.gapped_extend.restype = i64
    lib.seed_chunk_count.argtypes = [u8p, i64, i64, i64, i32p, i32p, i64,
                                     i64, i64, i64, i32p, i32p, i64p]
    lib.seed_chunk_count.restype = i64
    lib.seed_plan_batches.argtypes = [i32p, i64, i64, i64, i64p, i64p, i64]
    lib.seed_plan_batches.restype = i64
    lib.seed_chunk_emit.argtypes = [i32p, i32p, i32p, i64, i64, i64, i64,
                                    i64, i32p, i32p]
    lib.seed_chunk_emit.restype = None
    lib.build_seed_table_native.argtypes = [u8p, i64, i64, i32p, i64, i64,
                                            i64, i32p, i32p, i32p]
    lib.build_seed_table_native.restype = i64
    lib.entropy_counts.argtypes = [u8p, i64, u8p, i64, i64p, i64p, i64p,
                                   i64, i64p]
    lib.entropy_counts.restype = None


def get_lib():
    """The loaded native library, built at the first call. Raises if the
    build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.native_lib_path())
            _bind(lib)
            _lib = lib
        return _lib


def _as_i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def dedup_pairwise_native(rs, qs, ln, sc):
    lib = get_lib()
    rs, qs, ln, sc = (np.ascontiguousarray(a, np.int64)
                      for a in (rs, qs, ln, sc))
    m = lib.dedup_pairwise(_as_i64p(rs), _as_i64p(qs), _as_i64p(ln),
                           _as_i64p(sc), len(rs))
    return rs[:m], qs[:m], ln[:m], sc[:m]


def dedup_rm_native(rs, qs, ln, sc):
    lib = get_lib()
    rs, qs, ln, sc = (np.ascontiguousarray(a, np.int64)
                      for a in (rs, qs, ln, sc))
    m = lib.dedup_rm(_as_i64p(rs), _as_i64p(qs), _as_i64p(ln),
                     _as_i64p(sc), len(rs))
    return rs[:m], qs[:m], ln[:m], sc[:m]


def _as_i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def check_chunk_hits(num_hits: int, chunk_start: int,
                     int32_cum: bool = False):
    """Raise when one chunk-strand's seed hits pass the ceiling:
    SEGALIGN_MAX_CHUNK_HITS (2^28 by default, read on every call), and on
    the device routes, whose cumulative hit counts are int32, 2^31 - 1.

    The native route materializes a chunk's whole hit stream on the host
    (2 x 4 B a hit), and unmasked low-complexity sequence (poly-A runs and
    the like) can count hundreds of billions of hits for one 250 kb chunk:
    fail with an actionable message instead of a 400 GiB allocation, or,
    on the device routes, a cumulative count that wraps. The reference's
    analog is its MAX_SEEDS assert (src/seed_filter.cu:688-692); its
    intended workflow for repeat-dense genomes is soft-masking
    (run_segalign_repeat_masker), the same as here."""
    cap = int(os.environ.get("SEGALIGN_MAX_CHUNK_HITS", str(1 << 28)))
    if int32_cum:
        cap = min(cap, (1 << 31) - 1)
    if num_hits > cap:
        raise RuntimeError(
            f"chunk at query offset {chunk_start} produces "
            f"{num_hits:,} seed hits (> {cap:,}); this is "
            f"low-complexity/repeat-dense sequence that should be "
            f"soft-masked first (run run_segalign_repeat_masker, or "
            f"RepeatMasker/tantan), or raise SEGALIGN_MAX_CHUNK_HITS "
            f"if you really want to align it")


class ChunkSeeder:
    """Host-native seeding + hit expansion for one (table, query) residency.

    Replaces the device chunk_seeds/expand_hits programs; see seeder.cpp for
    the exact-semantics contract. Scratch buffers are reused across chunks."""

    def __init__(self, chunk_size: int, kmer_size: int, transition: bool,
                 nthreads: int = 0):
        self.nvar = 1 + kmer_size if transition else 1
        self.S_cap = chunk_size * self.nvar
        self.cnt = np.zeros(self.S_cap, np.int32)
        self.bstart = np.zeros(self.S_cap, np.int32)
        if nthreads <= 0:
            nthreads = os.cpu_count() or 1
        self.nthreads = nthreads

    def seed(self, query_codes: np.ndarray, chunk_start: int,
             chunk_len: int, index_table: np.ndarray,
             pos_table: np.ndarray, shape_pos, seed_size: int,
             max_hits: int):
        """Returns (ref_loc, query_loc, limit_pos, hit_bound, num_seeds,
        num_hits)."""
        lib = get_lib()
        query_codes = np.ascontiguousarray(query_codes, np.uint8)
        index_table = np.ascontiguousarray(index_table, np.int32)
        pos_table = np.ascontiguousarray(pos_table, np.int32)
        sp = np.ascontiguousarray(np.asarray(shape_pos), np.int32)
        k = len(sp)
        S = chunk_len * self.nvar
        assert S <= self.S_cap
        ns = np.zeros(1, np.int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        num_hits = lib.seed_chunk_count(
            query_codes.ctypes.data_as(u8p), len(query_codes),
            chunk_start, chunk_len, _as_i32p(index_table), _as_i32p(sp),
            k, seed_size, int(self.nvar > 1), self.nthreads,
            _as_i32p(self.cnt), _as_i32p(self.bstart), _as_i64p(ns))
        num_seeds = int(ns[0])
        if num_seeds == 0 or num_hits == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.int64), np.zeros(0, np.int64),
                    num_seeds, int(num_hits))
        check_chunk_hits(num_hits, chunk_start)
        cap = num_hits // max(max_hits, 1) + 4
        limit_pos = np.zeros(cap, np.int64)
        hit_bound = np.zeros(cap, np.int64)
        nb = lib.seed_plan_batches(
            _as_i32p(self.cnt), S, num_hits, max_hits,
            _as_i64p(limit_pos), _as_i64p(hit_bound), cap)
        assert nb <= cap
        ref_loc = np.empty(num_hits, np.int32)
        query_loc = np.empty(num_hits, np.int32)
        lib.seed_chunk_emit(
            _as_i32p(pos_table), _as_i32p(self.cnt), _as_i32p(self.bstart),
            S, chunk_start, seed_size, self.nvar, self.nthreads,
            _as_i32p(ref_loc), _as_i32p(query_loc))
        return (ref_loc, query_loc, limit_pos[:nb], hit_bound[:nb],
                num_seeds, int(num_hits))


def gapped_extend_native(ref_codes, query_codes, sub8x8, gap_open,
                         gap_extend, ydrop, anchor_r, anchor_q,
                         max_ops: int = 1 << 22):
    """One ydrop gapped extension. Returns (score, r_start, q_start, r_end,
    q_end, ops bytes), or None if the traceback outgrew max_ops."""
    lib = get_lib()
    ref_codes = np.ascontiguousarray(ref_codes, np.uint8)
    query_codes = np.ascontiguousarray(query_codes, np.uint8)
    sub = np.ascontiguousarray(sub8x8, np.int64)
    ops = np.empty(max_ops, np.uint8)  # write-only out buffer
    meta = np.zeros(5, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.gapped_extend(
        ref_codes.ctypes.data_as(u8p), len(ref_codes),
        query_codes.ctypes.data_as(u8p), len(query_codes),
        _as_i64p(sub), gap_open, gap_extend, ydrop,
        int(anchor_r), int(anchor_q),
        ops.ctypes.data_as(u8p), max_ops, _as_i64p(meta))
    if n < 0:
        return None
    return (int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]),
            int(meta[4]), bytes(ops[:n]))


def entropy_counts_host(ref_codes: np.ndarray, q_codes: np.ndarray,
                        rs: np.ndarray, qs: np.ndarray,
                        ln: np.ndarray) -> np.ndarray:
    """Per-HSP A/C/G/T match counts over the final extent [rs, rs+ln] x
    [qs, qs+ln] (ln+1 positions; matches are equal codes < 4). Inputs are
    int64 1-D arrays."""
    n = len(rs)
    out = np.zeros((n, 4), np.int64)
    if n == 0:
        return out
    rs = np.ascontiguousarray(rs, np.int64)
    qs = np.ascontiguousarray(qs, np.int64)
    ln = np.ascontiguousarray(ln, np.int64)
    ref_codes = np.ascontiguousarray(ref_codes, np.uint8)
    q_codes = np.ascontiguousarray(q_codes, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    get_lib().entropy_counts(
        ref_codes.ctypes.data_as(u8p), len(ref_codes),
        q_codes.ctypes.data_as(u8p), len(q_codes),
        _as_i64p(rs), _as_i64p(qs), _as_i64p(ln), n, _as_i64p(out))
    return out


def build_seed_table_fast(ref_codes, step: int, shape_pos, seed_size: int,
                          kmer_size: int):
    """Native threaded table build; returns (index_table, pos_table).
    index/seed_table.py::build_seed_table is its caller."""
    lib = get_lib()
    ref_codes = np.ascontiguousarray(ref_codes, np.uint8)
    sp = np.ascontiguousarray(np.asarray(shape_pos), np.int32)
    offset = (seed_size + 1) % step
    num_steps = (len(ref_codes) - seed_size + offset) // step
    tablesize = 4 ** kmer_size
    index_table = np.zeros(tablesize, np.int32)
    if num_steps <= 0:
        return index_table, np.zeros(0, np.int32)
    pos_table = np.empty(num_steps, np.int32)
    kscratch = np.empty(num_steps, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.build_seed_table_native(
        ref_codes.ctypes.data_as(u8p), len(ref_codes), step, _as_i32p(sp),
        kmer_size, seed_size, os.cpu_count() or 1, _as_i32p(index_table),
        _as_i32p(pos_table), _as_i32p(kscratch))
    return index_table, pos_table[:n]
