"""Build the port's native code at first use and load it with ctypes.

Two libraries, each keyed by a hash of its sources and flags and built
into build/segalign_tpu_torch/ at the root of the checkout:

  - the CUDA kernels, from segalign_tpu_torch/csrc/*.cu, with nvcc for
    sm_90a: one nvcc per source, all started together, then one link.
    Every source exports a plain `extern "C"` launcher that takes a
    cudaStream_t and returns cudaGetLastError(); nothing includes PyTorch's
    headers, which keeps the build short.
  - the shared native host library of segalign_tpu (seeder, dedup,
    entropy counts, gapped extension), from segalign_tpu/native/*.cpp with
    g++. The copy committed beside those sources is built for the machine
    that built it (-march=native) and may not load elsewhere, so the port
    builds its own portable copy and points segalign_tpu.native at it
    before that module loads anything.

A failed build raises with the compiler's stderr. Builds write to a
temporary name and rename, so processes that race on a cold build directory
never load a partial library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_ROOT, "build", "segalign_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every launcher: a pointer or the stream is c_void_p, never a
# bare int (ctypes would pass it as 32 bits and cut it)
_SIGNATURES = {
    "sa_gather_rows": [_P, ctypes.c_int64, _P, _I, _I, _P, _P],
    "sa_gather_rows_tile": [_P, ctypes.c_int64, _P, _I, _I, _I, _P, _P],
    "sa_first_scan": [_P] * 6 + [_I] * 6 + [_P] * 13,
    "sa_window_scan": [_P] * 11 + [_I] * 8 + [_P] * 7,
    "sa_window_scan_wide": [_P] * 11 + [_I] * 8 + [_P] * 7,
    "sa_gather_dma_only": [_P, _P, _I, _I, _P, _P],
    "sa_gather_extract_only": [_P, _P, _I, _I, _P, _P],
    "sa_gather_dbuf": [_P, _P, _I, _I, _P, _P],
    "sa_gather_two_sided": [_P, _P, _P, _I, _I, _P, _P, _P],
    "sa_scale2": [_P, ctypes.c_int64, _P, _P],
}

_lock = threading.Lock()
_kernels = None


def _digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(cmd, srcs, out):
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    r = subprocess.run([*cmd, *srcs, "-o", tmp], capture_output=True,
                       text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"(exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def kernels_path() -> str:
    """Build the CUDA kernel library if its hash is new; return its path."""
    srcs = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
    deps = srcs + sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
    out = os.path.join(BUILD_DIR, f"kernels-{_digest(deps, NVCC_FLAGS)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, os.path.basename(s) + ".o")
                for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", os.path.join(_PKG, "csrc"), "-c", s,
             "-o", o], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for s, o in zip(srcs, objs)]
        # wait for every compiler before raising for any of them
        errs = [p.communicate()[1] for p in procs]
        for s, p, err in zip(srcs, procs, errs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(s)} "
                                   f"(exit {p.returncode}):\n{err}")
        _compile([nvcc, "-shared"], objs, out)
    return out


def kernels():
    """The loaded kernel library (built at the first call)."""
    global _kernels
    with _lock:
        if _kernels is None:
            lib = ctypes.CDLL(kernels_path())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.sa_error_string.argtypes = [ctypes.c_int]
            lib.sa_error_string.restype = ctypes.c_char_p
            _kernels = lib
        return _kernels


def launch(name: str, *args) -> None:
    """Call one launcher and raise if CUDA refused the launch."""
    lib = kernels()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.sa_error_string(err).decode()}")


def native_lib_path() -> str:
    """Build the shared native host library if its hash is new, point
    segalign_tpu.native at it, and return its path."""
    import segalign_tpu.native as native
    srcs = list(native._SRCS)
    out = os.path.join(BUILD_DIR, f"native-{_digest(srcs, GXX_FLAGS)}.so")
    with _lock:
        if not os.path.exists(out):
            _compile(["g++", *GXX_FLAGS], srcs, out)
        # segalign_tpu.native rebuilds a library older than its sources in
        # place; a fresh mtime keeps it from overwriting this one
        os.utime(out)
        if native._lib is None:
            native._LIB = out
    return out
