"""Gapped-extension stage: LASTZ delegation process pool.

The reference performs gapped ydrop extension by eval-ing lastz command
lines emitted on stdout, capped at nproc concurrent processes
(reference/scripts/run_segalign:112-117). This module is the same
executor as a Python process pool, plus the post-hoc FAILURE check
(:124-131).

A native (non-LASTZ) gapped path lives in output/native_gapped.py
(DP core in native/gapped.cpp); delegation remains the byte-compatibility mode.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys
import threading
from typing import List


class LastzPool:
    """Bounded pool of shell jobs (one per lastz command line)."""

    def __init__(self, cwd: str, max_jobs: int | None = None):
        self.cwd = cwd
        self.max_jobs = max_jobs or os.cpu_count() or 4
        self.sem = threading.Semaphore(self.max_jobs)
        self.procs: List[subprocess.Popen] = []
        self.lock = threading.Lock()
        self.count = 0
        self.failures = 0

    def submit(self, cmd: str):
        self.count += 1
        self.sem.acquire()
        p = subprocess.Popen(cmd, shell=True, cwd=self.cwd,
                             executable="/bin/bash")
        with self.lock:
            self.procs.append(p)
        threading.Thread(target=self._reap, args=(p,), daemon=True).start()

    def _reap(self, p: subprocess.Popen):
        rc = p.wait()
        if rc != 0:
            with self.lock:
                self.failures += 1
        self.sem.release()

    def wait_all(self):
        with self.lock:
            procs = list(self.procs)
        for p in procs:
            p.wait()


def have_lastz() -> bool:
    return shutil.which("lastz") is not None


def have_fa_to_two_bit() -> bool:
    return shutil.which("faToTwoBit") is not None


def check_lastz_errors(out_dir: str) -> bool:
    """grep FAILURE *.err (run_segalign script:124-131). Returns True if
    any failure; removes .err files otherwise."""
    errs = glob.glob(os.path.join(out_dir, "*.err"))
    failed = False
    for e in errs:
        try:
            with open(e, "rb") as f:
                if b"FAILURE" in f.read():
                    failed = True
        except OSError:
            pass
    if failed:
        for e in errs:
            with open(e, "rb") as f:
                sys.stderr.buffer.write(f.read())
        return True
    for e in errs:
        os.remove(e)
    return False
