"""Native gapped-extension stage (no-LASTZ mode).

Drives the C++ ydrop DP (native/gapped.cpp) over the segments files the
ungapped stage produced, replacing the LASTZ delegation step when lastz is
not installed. Semantics follow lastz's gapped stage functionally:

  - each segment is reduced to its midpoint anchor;
  - anchors are processed in decreasing segment-score order; an anchor whose
    point already lies inside a kept alignment (on both sequences) is
    skipped (interference);
  - each anchor is extended with affine-gap ydrop DP in both directions;
  - alignments scoring >= gappedthresh are emitted.

Output is valid MAF/AXT but NOT byte-identical to LASTZ; delegation mode
(run_segalign with lastz installed) remains the byte-compat path.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..io.fasta import read_fasta
from ..native import gapped_extend_native
from .scoring import (default_gapped_matrix, parse_scoring_file,
                      encode_gapped, GAP_OPEN_DEFAULT, GAP_EXTEND_DEFAULT)

# raw-byte reverse complement preserving case (display text for '-' strand)
RAW_RC_LUT = np.arange(256, dtype=np.uint8)
for a, b in (("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")):
    RAW_RC_LUT[ord(a)] = ord(b)
    RAW_RC_LUT[ord(b)] = ord(a)


@dataclass
class Alignment:
    rname: str
    qname: str
    r_start: int
    r_end: int
    q_start: int   # strand-local (rc coords when strand == '-')
    q_end: int
    strand: str
    score: int
    ops: bytes


class GenomeText:
    """Per-chromosome raw bytes + gapped codes (+ lazily built rc)."""

    def __init__(self, fasta_path: str):
        self.raw: Dict[str, np.ndarray] = {}
        self.codes: Dict[str, np.ndarray] = {}
        self.order: List[str] = []
        for rec in read_fasta(fasta_path):
            self.raw[rec.name] = rec.seq
            self.codes[rec.name] = encode_gapped(rec.seq)
            self.order.append(rec.name)
        self._rc_raw: Dict[str, np.ndarray] = {}
        self._rc_codes: Dict[str, np.ndarray] = {}

    def size(self, name: str) -> int:
        return len(self.raw[name])

    def rc_raw(self, name: str) -> np.ndarray:
        if name not in self._rc_raw:
            self._rc_raw[name] = RAW_RC_LUT[self.raw[name][::-1]]
        return self._rc_raw[name]

    def rc_codes(self, name: str) -> np.ndarray:
        if name not in self._rc_codes:
            self._rc_codes[name] = encode_gapped(self.rc_raw(name))
        return self._rc_codes[name]


def _parse_segments(path: str):
    segs = []
    with open(path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            if len(p) != 8:
                continue
            segs.append((p[0], int(p[1]), int(p[2]), p[3], int(p[4]),
                         int(p[5]), p[6], int(p[7])))
    return segs


class _InterferenceIndex:
    """Point-in-box queries over the kept alignments.

    Replaces the O(kept) scan per anchor (quadratic on repeat-dense
    mammalian intervals with 1e4-1e5 segments): kept alignments are
    bucketed by their target-coordinate range, so a query touches only the
    alignments overlapping the anchor's bucket."""

    SHIFT = 14  # 16 kb buckets

    def __init__(self):
        self._items: List[Alignment] = []
        self._buckets: Dict[tuple, List[int]] = {}

    def add(self, al: Alignment):
        i = len(self._items)
        self._items.append(al)
        for b in range(al.r_start >> self.SHIFT,
                       (max(al.r_end - 1, al.r_start) >> self.SHIFT) + 1):
            self._buckets.setdefault((al.rname, al.qname, b), []).append(i)

    def covered(self, rname: str, qname: str, mid_r: int,
                mid_q: int) -> bool:
        for i in self._buckets.get((rname, qname, mid_r >> self.SHIFT), ()):
            al = self._items[i]
            if (al.r_start <= mid_r < al.r_end and
                    al.q_start <= mid_q < al.q_end):
                return True
        return False


def _extend_file(seg_path: str, target: GenomeText, query: GenomeText,
                 sub, gap_open, gap_extend, ydrop, gappedthresh
                 ) -> List[Alignment]:
    strand = "-" if ".minus" in seg_path else "+"
    segs = _parse_segments(seg_path)
    # decreasing segment score; stable for determinism
    segs.sort(key=lambda s: -s[7])

    kept: List[Alignment] = []
    index = _InterferenceIndex()
    for (rname, rs1, re1, qname, qs1, qe1, st, score) in segs:
        ln = re1 - rs1  # segment len field; span covers ln+1 positions
        mid_r = (rs1 - 1) + (ln + 1) // 2
        mid_q = (qs1 - 1) + (ln + 1) // 2
        if index.covered(rname, qname, mid_r, mid_q):
            continue
        rcodes = target.codes[rname]
        qcodes = (query.rc_codes(qname) if strand == "-"
                  else query.codes[qname])
        r = gapped_extend_native(rcodes, qcodes, sub, gap_open, gap_extend,
                                 ydrop, mid_r, mid_q)
        if r is None:
            raise RuntimeError("native gapped library unavailable")
        g_score, g_rs, g_qs, g_re, g_qe, ops = r
        if g_score < gappedthresh or g_re <= g_rs:
            continue
        al = Alignment(rname, qname, g_rs, g_re, g_qs, g_qe, strand,
                       g_score, ops)
        kept.append(al)
        index.add(al)

    # deterministic output order: query chrom file order, then coordinates
    qorder = {n: i for i, n in enumerate(query.order)}
    kept.sort(key=lambda a: (qorder[a.qname], a.q_start, a.r_start,
                             -a.score))
    return kept


def _aligned_text(raw_r: np.ndarray, raw_q: np.ndarray, al: Alignment):
    rt, qt = [], []
    i, j = al.q_start, al.r_start
    for op in al.ops.decode():
        if op == "M":
            rt.append(chr(raw_r[j]))
            qt.append(chr(raw_q[i]))
            i += 1
            j += 1
        elif op == "I":
            rt.append("-")
            qt.append(chr(raw_q[i]))
            i += 1
        else:
            rt.append(chr(raw_r[j]))
            qt.append("-")
            j += 1
    return "".join(rt), "".join(qt)


def _cigar(ops: bytes) -> str:
    out = []
    prev = None
    n = 0
    for op in ops.decode():
        if op == prev:
            n += 1
        else:
            if prev:
                out.append(f"{n}{prev}")
            prev = op
            n = 1
    if prev:
        out.append(f"{n}{prev}")
    return "".join(out)


def _ungapped_blocks(al: Alignment):
    """Split the op string into ungapped (M-run) blocks; yields
    (r0, q0, r1, q1) per block (half-open ends)."""
    i, j = al.q_start, al.r_start
    run_r = run_q = -1
    for op in al.ops.decode():
        if op == "M":
            if run_r < 0:
                run_r, run_q = j, i
            i += 1
            j += 1
        else:
            if run_r >= 0:
                yield run_r, run_q, j, i
                run_r = run_q = -1
            if op == "I":
                i += 1
            else:
                j += 1
    if run_r >= 0:
        yield run_r, run_q, j, i


def _pct_id(raw_r, raw_q, r0, q0, r1, q1) -> float:
    a = raw_r[r0:r1]
    b = raw_q[q0:q1]
    if len(a) == 0:
        return 0.0
    # case-insensitive base identity
    eq = (a | 0x20) == (b | 0x20)
    return 100.0 * float(np.count_nonzero(eq)) / len(a)


def _write_lav(f, alignments, target, query, with_text):
    """Minimal valid LAV (blastz/lastz stanza structure): d-stanza, then
    per (target, query) pair s/h stanzas with the pair's a-blocks.
    Functional equivalent, not byte-identical to lastz's lav."""
    f.write("#:lav\n")
    f.write("d {\n  \"segalign_tpu native gapped\"\n}\n")
    pairs: Dict[tuple, List[Alignment]] = {}
    for al in alignments:
        pairs.setdefault((al.rname, al.qname, al.strand), []).append(al)
    for (rname, qname, strand), als in pairs.items():
        f.write("#:lav\n")
        rc = 1 if strand == "-" else 0
        f.write("s {\n")
        f.write(f"  \"{rname}\" 1 {target.size(rname)} 0 1\n")
        f.write(f"  \"{qname}{'-' if rc else ''}\" 1 {query.size(qname)} "
                f"{rc} 1\n")
        f.write("}\n")
        f.write("h {\n")
        f.write(f"   \"> {rname}\"\n")
        f.write(f"   \"> {qname}{' (reverse complement)' if rc else ''}\"\n")
        f.write("}\n")
        for al in als:
            raw_r = target.raw[al.rname]
            raw_q = (query.rc_raw(al.qname) if al.strand == "-"
                     else query.raw[al.qname])
            f.write("a {\n")
            f.write(f"  s {al.score}\n")
            f.write(f"  b {al.r_start + 1} {al.q_start + 1}\n")
            f.write(f"  e {al.r_end} {al.q_end}\n")
            for (r0, q0, r1, q1) in _ungapped_blocks(al):
                pct = _pct_id(raw_r, raw_q, r0, q0, r1, q1)
                f.write(f"  l {r0 + 1} {q0 + 1} {r1} {q1} {pct:.0f}\n")
            f.write("}\n")
            if with_text:
                rt, qt = _aligned_text(raw_r, raw_q, al)
                f.write(f"  \"{rt}\"\n  \"{qt}\"\n")
    f.write("#:eof\n")


def _write_text_block(f, al, rt, qt, width=60):
    f.write(f"  score = {al.score}\n")
    f.write(f"  target: {al.rname} {al.r_start + 1}..{al.r_end}\n")
    f.write(f"  query:  {al.qname} {al.q_start + 1}..{al.q_end} "
            f"({al.strand})\n")
    for i in range(0, len(rt), width):
        a = rt[i:i + width]
        b = qt[i:i + width]
        mid = "".join("|" if (x != "-" and x.upper() == y.upper()) else " "
                      for x, y in zip(a, b))
        f.write(f"    {a}\n    {mid}\n    {b}\n\n")


NATIVE_FORMATS = ("maf", "maf+", "maf-", "axt", "axt+", "sam", "softsam",
                  "sam-", "softsam-", "cigar", "differences", "rdotplot",
                  "text", "lav", "lav+text")


def write_alignments(path: str, fmt: str, alignments: List[Alignment],
                     target: GenomeText, query: GenomeText):
    sam = fmt in ("sam", "softsam", "sam-", "softsam-")
    with open(path, "w") as f:
        if fmt in ("maf", "maf+"):
            f.write("##maf version=1 scoring=segalign_tpu\n")
        if fmt in ("lav", "lav+text"):
            _write_lav(f, alignments, target, query, fmt == "lav+text")
            return
        if sam and not fmt.endswith("-"):
            f.write("@HD\tVN:1.5\tSO:unsorted\n")
            for name in target.order:
                f.write(f"@SQ\tSN:{name}\tLN:{target.size(name)}\n")
            f.write("@PG\tID:segalign_tpu\tPN:segalign_tpu\n")
        idx = 0
        for al in alignments:
            raw_r = target.raw[al.rname]
            raw_q = (query.rc_raw(al.qname) if al.strand == "-"
                     else query.raw[al.qname])
            rt, qt = _aligned_text(raw_r, raw_q, al)
            if fmt.startswith("maf"):
                f.write(f"a score={al.score}\n")
                f.write(f"s {al.rname} {al.r_start} "
                        f"{al.r_end - al.r_start} + "
                        f"{target.size(al.rname)} {rt}\n")
                f.write(f"s {al.qname} {al.q_start} "
                        f"{al.q_end - al.q_start} {al.strand} "
                        f"{query.size(al.qname)} {qt}\n\n")
            elif fmt in ("axt", "axt+"):
                f.write(f"{idx} {al.rname} {al.r_start + 1} {al.r_end} "
                        f"{al.qname} {al.q_start + 1} {al.q_end} "
                        f"{al.strand} {al.score}\n{rt}\n{qt}\n\n")
            elif fmt == "cigar":
                import itertools
                runs = " ".join(
                    f"{k} {len(list(g))}"
                    for k, g in itertools.groupby(al.ops.decode()))
                f.write(f"cigar: {al.qname} {al.q_start} {al.q_end} "
                        f"{al.strand} {al.rname} {al.r_start} {al.r_end} + "
                        f"{al.score} {runs}\n")
            elif fmt == "differences":
                # one row per difference run (mismatch or gap), with the
                # differing text from both sequences
                i, j = al.q_start, al.r_start
                run = None  # (r0, q0)
                for op in al.ops.decode() + "$":
                    if op == "$":
                        diff = False
                    elif op == "M":
                        diff = (raw_r[j] | 0x20) != (raw_q[i] | 0x20)
                    else:
                        diff = True
                    if not diff and run is not None:
                        r0, q0 = run
                        rtxt = bytes(raw_r[r0:j]).decode() or "-"
                        qtxt = bytes(raw_q[q0:i]).decode() or "-"
                        f.write(f"{al.rname}\t{r0}\t{j}\t+\t{al.qname}\t"
                                f"{q0}\t{i}\t{al.strand}\t{rtxt}\t{qtxt}\n")
                        run = None
                    if diff and run is None:
                        run = (j, i)
                    if op == "M":
                        i += 1
                        j += 1
                    elif op == "I":
                        i += 1
                    elif op == "D":
                        j += 1
            elif fmt == "rdotplot":
                if idx == 0:
                    f.write(f"{al.rname}\t{al.qname}\n")
                for (r0, q0, r1, q1) in _ungapped_blocks(al):
                    if al.strand == "-":
                        qsize = query.size(al.qname)
                        f.write(f"{r0 + 1}\t{qsize - q0}\n")
                        f.write(f"{r1}\t{qsize - q1 + 1}\n")
                    else:
                        f.write(f"{r0 + 1}\t{q0 + 1}\n")
                        f.write(f"{r1}\t{q1}\n")
                    f.write("NA\tNA\n")
            elif fmt == "text":
                _write_text_block(f, al, rt, qt)
            elif sam:
                soft = fmt.startswith("softsam")
                flag = 16 if al.strand == "-" else 0
                qsize = query.size(al.qname)
                # strand-local clip lengths
                pre = al.q_start
                post = qsize - al.q_end
                cig = _cigar(al.ops)
                if soft:
                    seq = bytes(raw_q).decode()
                    cl = (f"{pre}S" if pre else "") + cig + \
                        (f"{post}S" if post else "")
                else:
                    seq = bytes(raw_q[al.q_start:al.q_end]).decode()
                    cl = (f"{pre}H" if pre else "") + cig + \
                        (f"{post}H" if post else "")
                f.write(f"{al.qname}\t{flag}\t{al.rname}\t{al.r_start + 1}"
                        f"\t255\t{cl}\t*\t0\t0\t{seq}\t*\tAS:i:{al.score}"
                        f"\n")
            else:
                raise NotImplementedError(
                    f"native gapped mode supports {'/'.join(NATIVE_FORMATS)};"
                    f" --format={fmt} (e.g. BLASTN) requires lastz "
                    f"(delegation mode)")
            idx += 1


def _trivial_alignments(target: GenomeText, query: GenomeText, sub
                        ) -> List[Alignment]:
    """Full-length identity alignments for (target chrom, query chrom)
    pairs with identical sequence — lastz's trivial self-alignment block
    (suppressed by --notrivial; reference/src/main.cpp:93)."""
    out = []
    by_len: Dict[int, List[str]] = {}
    for rn in target.order:
        by_len.setdefault(target.size(rn), []).append(rn)
    for qn in query.order:
        for rn in by_len.get(query.size(qn), ()):
            raw_r = target.raw[rn]
            raw_q = query.raw[qn]
            if not np.array_equal(raw_r | 0x20, raw_q | 0x20):
                continue
            codes = target.codes[rn]
            score = int(np.sum(sub[codes, codes]))
            n = len(raw_r)
            out.append(Alignment(rn, qn, 0, n, 0, n, "+", score,
                                 b"M" * n))
    return out


def run_native_gapped(cfg, out_dir: str, max_workers: int | None = None
                      ) -> int:
    """Extend every tmp*.segments in out_dir; writes tmp*.<fmt> next to
    them. Returns the number of output files written."""
    target = GenomeText(cfg.reference_filename)
    query = GenomeText(cfg.query_filename)

    if cfg.scoring_file:
        sub, gap_open, gap_extend = parse_scoring_file(cfg.scoring_file)
    else:
        sub = default_gapped_matrix(cfg.ambiguous)
        gap_open, gap_extend = GAP_OPEN_DEFAULT, GAP_EXTEND_DEFAULT

    if not getattr(cfg, "notrivial", False):
        trivial = _trivial_alignments(target, query, sub)
        if trivial:
            # one dedicated plus-strand tmp file (picked up by the sort -V
            # merge); lastz emits the block per invocation instead — here
            # it appears once in the merged output
            path = os.path.join(out_dir,
                                f"tmp0.trivial.plus.{cfg.output_format}")
            write_alignments(path, cfg.output_format, trivial, target,
                             query)

    seg_files = sorted(glob.glob(os.path.join(out_dir, "tmp*.segments")))

    def work(seg_path: str) -> int:
        als = _extend_file(seg_path, target, query, sub, gap_open,
                           gap_extend, cfg.ydrop, cfg.gappedthresh)
        out_path = seg_path[:-len(".segments")] + f".{cfg.output_format}"
        write_alignments(out_path, cfg.output_format, als, target, query)
        return 1

    n = 0
    with ThreadPoolExecutor(max_workers=max_workers or os.cpu_count()) as ex:
        for r in ex.map(work, seg_files):
            n += r
    return n
