"""run_segalign on the port: the pairwise driver.

Counterpart of segalign_tpu/cli/run_segalign.py, with the same options and
exit codes (4 file not found, 5 permissions, 6 LASTZ failure, 8 2bit
conversion failed), the same LASTZ pool or native gapped stage and the same
sort -V merge (the port's own copies of that host code); the ungapped
stage is the port's run_pairwise. One choice is the port's own: --device,
the torch device of the ungapped stage (default cuda; the run fails when
CUDA is not available rather than running elsewhere). SEGALIGN_DEVICE_
SEEDING=1 selects the device-seeding route, read by the aligner as in the
JAX package.
"""

from __future__ import annotations

import os
import random
import shutil
import subprocess
import sys

import torch

from ..output.gapped import (LastzPool, check_lastz_errors,
                             have_fa_to_two_bit, have_lastz)
from ..output.merge import merge_outputs, sorted_glob
from .args import (apply_multihost_args, build_pairwise_parser,
                   pairwise_config_from_args)


def build_parser():
    p = build_pairwise_parser()
    p.add_argument("--device", default="cuda",
                   help="torch device of the ungapped stage (cuda, cuda:N "
                        "or cpu)")
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    apply_multihost_args(args)
    if not args.target or not args.query:
        print("You must specify a target file and a query file",
              file=sys.stderr)
        build_parser().print_help(sys.stderr)
        return 1
    device = resolve_device(args.device)

    ref_path = os.path.realpath(args.target)
    query_path = os.path.realpath(args.query)
    for p in (ref_path, query_path):
        if not os.path.isfile(p):
            print(f"input file {p} does not exist", file=sys.stderr)
            return 4
    output_path = os.path.realpath(args.output) if args.output else None

    cwd = os.getcwd()
    if not os.access(cwd, os.W_OK):
        print(f"Cannot create output directory in {cwd} because of "
              f"permissions", file=sys.stderr)
        return 5

    if args.workdir:
        out_dir = os.path.realpath(args.workdir)
    else:
        out_dir = os.path.join(cwd, f"output_{random.randrange(32768)}")
    data_dir = os.path.join(out_dir, f"data_{random.randrange(32768)}") + "/"
    os.makedirs(data_dir, exist_ok=True)

    gapped = not args.nogapped
    mode = args.gapped_mode
    if mode == "auto":
        mode = ("delegate" if have_lastz() and have_fa_to_two_bit()
                else "native")
    try:
        if gapped and mode == "delegate":
            if not have_lastz() or not have_fa_to_two_bit():
                print("error: --gapped_mode=delegate requires `lastz` and "
                      "`faToTwoBit` on PATH; use --gapped_mode=native or "
                      "--nogapped", file=sys.stderr)
                return 4
            print("\nConverting fasta files to 2bit format", file=sys.stderr)
            try:
                subprocess.check_call(["faToTwoBit", ref_path,
                                       os.path.join(data_dir, "ref.2bit")])
                subprocess.check_call(["faToTwoBit", query_path,
                                       os.path.join(data_dir, "query.2bit")])
            except (subprocess.CalledProcessError, OSError) as e:
                print(f"error: 2bit conversion failed: {e}", file=sys.stderr)
                return 8

        args.target, args.query, args.data_folder = (ref_path, query_path,
                                                     data_dir)
        cfg = pairwise_config_from_args(args)
        if gapped and mode == "native":
            # command emission is pointless without lastz
            cfg.gapped = False

        pool = LastzPool(cwd=out_dir)
        emit = (pool.submit if gapped and mode == "delegate"
                else (lambda cmd: None))

        from ..pipeline.pairwise import run_pairwise
        run_pairwise(cfg, out_dir, device=device, emit=emit,
                     resume=args.resume)
        pool.wait_all()

        shutil.rmtree(data_dir, ignore_errors=True)

        if gapped and mode == "native":
            print("\nRunning native gapped extension ...", file=sys.stderr)
            from ..output.native_gapped import run_native_gapped
            cfg.gapped = True
            run_native_gapped(cfg, out_dir)
            for f in sorted_glob(os.path.join(out_dir, "tmp*.segments")):
                os.remove(f)
        elif gapped and pool.count > 0:
            if check_lastz_errors(out_dir) or pool.failures:
                print("\nError in LASTZ process!", file=sys.stderr)
                return 6
            for f in sorted_glob(os.path.join(out_dir, "tmp*.segments")):
                os.remove(f)

        produced = (sorted_glob(os.path.join(out_dir, "tmp*.plus.*")) or
                    sorted_glob(os.path.join(out_dir, "tmp*.minus.*")))
        if produced:
            merge_outputs(out_dir, output_path, args.markend)
        else:
            print("No alignment generated")
        shutil.rmtree(out_dir, ignore_errors=True)
        return 0
    finally:
        # with a pinned --workdir, keep state on failure so --resume works
        if not args.workdir:
            shutil.rmtree(out_dir, ignore_errors=True)
        else:
            shutil.rmtree(data_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
