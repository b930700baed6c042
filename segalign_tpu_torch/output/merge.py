"""Output merge: GNU `sort -V` ordered concatenation of tmp files.

Replicates the bash script's merge (reference/scripts/run_segalign:149-191):
all tmp*.plus.* files in version-sort order, then all tmp*.minus.*.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List


def version_key(s: str):
    """Sort key emulating GNU sort -V for our tmp-file names (alternating
    text/number runs, digit runs compared numerically)."""
    parts = re.split(r"(\d+)", s)
    key = []
    for p in parts:
        if p.isdigit():
            key.append((0, int(p), ""))
        else:
            key.append((1, 0, p))
    return key


def sorted_glob(pattern: str) -> List[str]:
    return sorted(glob.glob(pattern), key=lambda p: version_key(
        os.path.basename(p)))


def merge_outputs(out_dir: str, output_path: str | None, markend: bool,
                  remove: bool = True):
    """Concatenate tmp*.plus.* then tmp*.minus.* (sort -V order) into
    output_path (or stdout when None)."""
    import sys
    dst = open(output_path, "wb") if output_path else sys.stdout.buffer
    try:
        for pattern in ("tmp*.plus.*", "tmp*.minus.*"):
            for path in sorted_glob(os.path.join(out_dir, pattern)):
                with open(path, "rb") as f:
                    dst.write(f.read())
                if remove:
                    os.remove(path)
        if markend:
            dst.write(b"# segalign end-of-file\n")
    finally:
        if output_path:
            dst.close()
        else:
            sys.stdout.buffer.flush()
