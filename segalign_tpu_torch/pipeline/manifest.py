"""Chunk-granular checkpoint/resume manifest.

The reference has no resume capability (SURVEY section 5): a crash loses
everything. Here every completed work item (one interval of one
ref-block x query-block pair) appends a JSON line to MANIFEST in the work
directory; a resumed run skips completed intervals, whose tmp output files
are still on disk and participate in the final merge as usual.
"""

from __future__ import annotations

import json
import os
from typing import Set, Tuple

MANIFEST_NAME = "MANIFEST.jsonl"

Key = Tuple[int, int, int]  # (ref_block, query_block, num_invoked)


class Manifest:
    def __init__(self, out_dir: str, resume: bool = False):
        self.path = os.path.join(out_dir, MANIFEST_NAME)
        self.done: Set[Key] = set()
        if resume and os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn write at crash: ignore
                    if rec.get("done"):
                        self.done.add((rec["r"], rec["q"], rec["i"]))
        self._f = open(self.path, "a")

    def is_done(self, key: Key) -> bool:
        return key in self.done

    def mark_done(self, key: Key, files=()):
        rec = {"r": key[0], "q": key[1], "i": key[2], "done": True,
               "files": list(files)}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self.done.add(key)

    def close(self):
        self._f.close()
