"""Segment-file output and LASTZ command emission (pairwise mode).

Replicates segment_printer_body (reference/src/segment_printer.cpp)
byte-for-byte: tmp file naming, 1-based closed-ish coordinates, minus-strand
reversal, and the exact lastz command line the bash run_segalign script
evals.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class PrinterContext:
    """Chromosome coordinate tables (absolute arena positions)."""
    r_chr_names: List[str]
    r_chr_starts: np.ndarray
    q_chr_names: List[str]
    q_chr_starts: np.ndarray
    rc_q_chr_names: List[str]
    rc_q_chr_starts: np.ndarray
    rc_q_chr_lens: np.ndarray
    out_dir: str


def _chr_index(starts: np.ndarray, pos: int) -> int:
    # std::upper_bound(...) - 1
    return int(np.searchsorted(starts, pos, side="right")) - 1


def write_interval_segments(ctx: PrinterContext, cfg, *, num_invoked: int,
                            q_block_index: int, r_block_index: int,
                            r_block_start: int, q_block_start: int,
                            fw_hsps: np.ndarray, rc_hsps: np.ndarray
                            ) -> List[str]:
    """Write the plus/minus .segments files for one interval and return the
    lastz command lines to run (empty unless cfg.gapped).

    fw_hsps/rc_hsps: (n, 4) int64 arrays (ref_start, query_start, len, score)
    in block-relative coordinates, accumulated over the interval's chunks.
    """
    cmds: List[str] = []
    if len(fw_hsps) + len(rc_hsps) == 0:
        return cmds

    def fmt_lines(hsps, q_names, q_starts, strand):
        lines = []
        for ref_start, query_start, ln, score in hsps:
            seg_r = int(ref_start) + r_block_start
            seg_q = int(query_start) + q_block_start
            ri = _chr_index(ctx.r_chr_starts, seg_r)
            qi = _chr_index(q_starts, seg_q)
            r0 = int(ctx.r_chr_starts[ri])
            q0 = int(q_starts[qi])
            lines.append(
                f"{ctx.r_chr_names[ri]}\t{seg_r + 1 - r0}\t"
                f"{seg_r + int(ln) + 1 - r0}\t{q_names[qi]}\t"
                f"{seg_q + 1 - q0}\t{seg_q + int(ln) + 1 - q0}\t"
                f"{strand}\t{int(score)}\n")
        return lines

    def lastz_cmd(base: str, strand: str) -> str:
        cmd = (f"lastz {cfg.data_folder}ref.2bit[nameparse=darkspace]"
               f"[multiple][subset=ref_block{r_block_index}.name] "
               f"{cfg.data_folder}query.2bit[nameparse=darkspace]"
               f"[subset=query_block{q_block_index}.name] "
               f"--format={cfg.output_format} --ydrop={cfg.ydrop} "
               f"--gappedthresh={cfg.gappedthresh} --strand={strand}")
        if cfg.ambiguous != "":
            cmd += f" --ambiguous={cfg.ambiguous}"
        if cfg.notrivial:
            cmd += " --notrivial"
        if cfg.scoring_file != "":
            cmd += f" --scoring={cfg.scoring_file}"
        cmd += (f" --segments={base}.segments "
                f"--output={base}.{cfg.output_format} 2> {base}.err")
        return cmd

    if len(fw_hsps) > 0:
        base = (f"tmp{num_invoked}.block{q_block_index}.r{r_block_start}"
                f".plus")
        with open(os.path.join(ctx.out_dir, base + ".segments"), "w") as f:
            f.writelines(fmt_lines(fw_hsps, ctx.q_chr_names,
                                   ctx.q_chr_starts, "+"))
        if cfg.gapped:
            cmds.append(lastz_cmd(base, "plus"))

    if len(rc_hsps) > 0:
        base = (f"tmp{num_invoked}.block{q_block_index}.r{r_block_start}"
                f".minus")
        # minus-strand HSPs are written in reverse accumulation order
        # (src/segment_printer.cpp:130)
        with open(os.path.join(ctx.out_dir, base + ".segments"), "w") as f:
            f.writelines(fmt_lines(rc_hsps[::-1], ctx.rc_q_chr_names,
                                   ctx.rc_q_chr_starts, "-"))
        if cfg.gapped:
            cmds.append(lastz_cmd(base, "minus"))

    return cmds
