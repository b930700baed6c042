"""run_segalign_repeat_masker on the port: the repeat-masker command line.

Counterpart of segalign_tpu/cli/run_segalign_repeat_masker.py, with the
same options and exit codes (4 file not found, 5 permissions) and the same
output: a header, then the tmp*.* interval files in sort -V order. One
choice is the port's own: --device, the torch device of the run (default
cuda; the run fails when CUDA is not available rather than running
elsewhere). SEGALIGN_DEVICE_SEEDING=1 selects the device-seeding route,
read by the aligner as in the JAX package.
"""

from __future__ import annotations

import os
import random
import shutil
import sys

from ..output.merge import sorted_glob
from .args import apply_multihost_args, build_rm_parser, rm_config_from_args
from .run_segalign import resolve_device

HEADER = "#name1  zstart1 end1  name2 zstart2+  end2+\n"


def build_parser():
    p = build_rm_parser()
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    apply_multihost_args(args)
    if not args.seq_file:
        print("You must specify a sequence file", file=sys.stderr)
        build_parser().print_help(sys.stderr)
        return 1
    device = resolve_device(args.device)

    seq_path = os.path.realpath(args.seq_file)
    if not os.path.isfile(seq_path):
        print(f"target file {seq_path} does not exist", file=sys.stderr)
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
    os.makedirs(out_dir, exist_ok=True)
    try:
        args.seq_file = seq_path
        cfg = rm_config_from_args(args)
        from ..pipeline.repeat_masker import run_repeat_masker
        run_repeat_masker(cfg, out_dir, device=device, resume=args.resume)

        parts = sorted_glob(os.path.join(out_dir, "tmp*.*"))
        end = ("# segalign_repeat_masker end-of-file\n" if args.markend
               else "")
        if output_path:
            with open(output_path, "wb") as dst:
                dst.write(HEADER.encode())
                for path in parts:
                    with open(path, "rb") as f:
                        dst.write(f.read())
                dst.write(end.encode())
        else:
            sys.stdout.write(HEADER)
            for path in parts:
                with open(path) as f:
                    sys.stdout.write(f.read())
            sys.stdout.write(end)
        return 0
    finally:
        # with a pinned --workdir, keep state so --resume works
        if not args.workdir:
            shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
