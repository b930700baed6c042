"""Command-line parsing mirroring the reference's boost::program_options
surface (reference/src/main.cpp:61-157 and
repeat_masker_src/main.cpp:43-126)."""

from __future__ import annotations

import argparse

from ..config import Config, RMConfig
from ..constants import (
    DEFAULT_WGA_CHUNK, DEFAULT_LASTZ_INTERVAL, DEFAULT_SEQ_BLOCK_SIZE,
    DEFAULT_SEQ_BLOCK_SIZE_RM, VERSION)


def _add_multihost_args(p: argparse.ArgumentParser) -> None:
    """Multi-host launch flags (v1 replicate-and-partition scale-out,
    parallel/distributed.py). Run the SAME command on every host with its
    own --host_id; each host aligns a round-robin slice of the intervals
    and writes its own output file (merge with sort -V, exactly like the
    reference's tmp-file merge). Equivalent env vars:
    SEGALIGN_NUM_HOSTS / SEGALIGN_HOST_ID / SEGALIGN_COORD."""
    p.add_argument("--num_hosts", type=int, default=0,
                   help="total number of cooperating hosts (launch this "
                        "command once per host)")
    p.add_argument("--host_id", type=int, default=-1,
                   help="this host's id in [0, num_hosts)")
    p.add_argument("--coordinator", default="",
                   help="ip:port of host 0's torch.distributed coordinator "
                        "(required for a multi-host device mesh, e.g. "
                        "--sharded_table across hosts; optional for the "
                        "replicated v1 mode, which needs no communication)")


def apply_multihost_args(a) -> None:
    """Export the CLI's multi-host flags as the SEGALIGN_* env contract
    consumed by parallel.distributed.maybe_initialize_distributed (flags
    win over pre-set env vars)."""
    import os
    if getattr(a, "num_hosts", 0) and a.num_hosts > 1:
        os.environ["SEGALIGN_NUM_HOSTS"] = str(a.num_hosts)
        if a.host_id >= 0:
            os.environ["SEGALIGN_HOST_ID"] = str(a.host_id)
        if a.coordinator:
            os.environ["SEGALIGN_COORD"] = a.coordinator


def build_pairwise_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="run_segalign",
        description="SegAlign-TPU: pairwise whole-genome aligner "
                    "(seed-filter-extend, LASTZ-compatible)")
    p.add_argument("target", nargs="?", help="target sequence file (FASTA)")
    p.add_argument("query", nargs="?", help="query sequence file (FASTA)")
    p.add_argument("data_folder", nargs="?", default="",
                   help="folder with 2bit files (internal)")
    p.add_argument("--strand", default="both",
                   choices=["plus", "minus", "both"])
    p.add_argument("--scoring", default="",
                   help="scoring file in LASTZ format (passed to lastz)")
    p.add_argument("--ambiguous", default="",
                   help="ambiguous nucleotides - n/iupac")
    p.add_argument("--seed", default="12of19", dest="seed_shape")
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--notransition", action="store_true")
    p.add_argument("--xdrop", type=int, default=910)
    p.add_argument("--hspthresh", type=int, default=3000)
    p.add_argument("--noentropy", action="store_true")
    p.add_argument("--nogapped", action="store_true")
    p.add_argument("--ydrop", type=int, default=9430)
    p.add_argument("--gappedthresh", type=int, default=None)
    p.add_argument("--notrivial", action="store_true")
    p.add_argument("--format", default="maf-", dest="output_format")
    p.add_argument("--output", default="")
    p.add_argument("--markend", action="store_true")
    p.add_argument("--wga_chunk_size", type=int, default=DEFAULT_WGA_CHUNK)
    p.add_argument("--lastz_interval_size", type=int,
                   default=DEFAULT_LASTZ_INTERVAL)
    p.add_argument("--seq_block_size", type=int,
                   default=DEFAULT_SEQ_BLOCK_SIZE)
    p.add_argument("--num_gpu", "--num_devices", type=int, default=-1,
                   dest="num_devices")
    p.add_argument("--max_hits", type=int, default=0,
                   help="iteration-batch size (reference: 4194304 per GB of "
                        "GPU memory); affects dedup batch boundaries")
    p.add_argument("--sharded_table", action="store_true",
                   help="shard the seed position table by k-mer range over "
                        "the device mesh (all_to_all seed routing) instead "
                        "of replicating it per device; for reference "
                        "blocks whose table exceeds one chip's HBM")
    p.add_argument("--gapped_mode", default="auto",
                   choices=["auto", "delegate", "native"],
                   help="gapped stage: delegate to lastz (byte-compatible "
                        "with the reference) or use the native ydrop "
                        "extension; auto = delegate when lastz is installed")
    p.add_argument("--workdir", default="",
                   help="pinned working directory (enables --resume); "
                        "default: a temp dir deleted on exit")
    p.add_argument("--resume", action="store_true",
                   help="skip intervals already recorded in the workdir's "
                        "manifest (requires --workdir)")
    _add_multihost_args(p)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--version", action="version",
                   version=f"SegAlign-TPU Version: {VERSION}")
    return p


def pairwise_config_from_args(a) -> Config:
    return Config(
        reference_filename=a.target or "",
        query_filename=a.query or "",
        data_folder=a.data_folder or "",
        strand=a.strand, scoring_file=a.scoring, ambiguous=a.ambiguous,
        seed_shape=a.seed_shape, step=a.step, notransition=a.notransition,
        xdrop=a.xdrop, hspthresh=a.hspthresh, noentropy=a.noentropy,
        gapped=not a.nogapped, ydrop=a.ydrop, gappedthresh=a.gappedthresh,
        notrivial=a.notrivial, output_format=a.output_format,
        output=a.output, markend=a.markend,
        wga_chunk_size=a.wga_chunk_size,
        lastz_interval_size=a.lastz_interval_size,
        seq_block_size=a.seq_block_size, num_devices=a.num_devices,
        max_hits=a.max_hits, sharded_table=a.sharded_table, debug=a.debug)


def build_rm_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="run_segalign_repeat_masker",
        description="SegAlign-TPU repeat masker: self-alignment coverage "
                    "intervals")
    p.add_argument("seq_file", nargs="?", help="sequence file (FASTA)")
    p.add_argument("--strand", default="both",
                   choices=["plus", "minus", "both"])
    p.add_argument("--neighbor_proportion", type=float, default=0.2)
    p.add_argument("--scoring", default="")
    p.add_argument("--ambiguous", default="")
    p.add_argument("--seed", default="12of19", dest="seed_shape")
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--notransition", action="store_true")
    p.add_argument("--xdrop", type=int, default=910)
    p.add_argument("--hspthresh", type=int, default=3000)
    p.add_argument("--noentropy", action="store_true")
    p.add_argument("--M", type=int, default=1)
    p.add_argument("--markend", action="store_true")
    p.add_argument("--output", default="")
    p.add_argument("--wga_chunk_size", type=int, default=DEFAULT_WGA_CHUNK)
    p.add_argument("--lastz_interval_size", type=int,
                   default=DEFAULT_LASTZ_INTERVAL)
    p.add_argument("--seq_block_size", type=int,
                   default=DEFAULT_SEQ_BLOCK_SIZE_RM)
    p.add_argument("--num_gpu", "--num_devices", type=int, default=-1,
                   dest="num_devices")
    p.add_argument("--max_hits", type=int, default=0)
    p.add_argument("--sharded_table", action="store_true",
                   help="shard the seed position table by k-mer range over "
                        "the device mesh (RM blocks are 1 GB, the mode "
                        "that outgrows one chip's HBM first)")
    p.add_argument("--workdir", default="",
                   help="pinned working directory (enables --resume)")
    p.add_argument("--resume", action="store_true")
    _add_multihost_args(p)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--version", action="version",
                   version=f"SegAlign-TPU Version: {VERSION}")
    return p


def rm_config_from_args(a) -> RMConfig:
    return RMConfig(
        seq_filename=a.seq_file or "",
        strand=a.strand, neighbor_proportion=a.neighbor_proportion,
        scoring_file=a.scoring, ambiguous=a.ambiguous,
        seed_shape=a.seed_shape, step=a.step, notransition=a.notransition,
        xdrop=a.xdrop, hspthresh=a.hspthresh, noentropy=a.noentropy,
        M=a.M, markend=a.markend, wga_chunk_size=a.wga_chunk_size,
        lastz_interval_size=a.lastz_interval_size,
        seq_block_size=a.seq_block_size, num_devices=a.num_devices,
        max_hits=a.max_hits, sharded_table=a.sharded_table, debug=a.debug)
