"""Build the port's native code at first use and load it with ctypes.

Two libraries, each keyed by a hash of its sources and flags and built
into build/segalign_tpu_torch/ at the root of the checkout:

  - the CUDA kernels, from segalign_tpu_torch/csrc/*.cu, with nvcc for
    sm_90a: one nvcc per source, all started together, then one link.
    Every source exports a plain `extern "C"` launcher that takes a
    cudaStream_t and returns cudaGetLastError(); nothing includes PyTorch's
    headers, which keeps the build short.
  - the native host library (seeder, seed table, dedup, entropy counts,
    gapped extension), from segalign_tpu_torch/native/*.cpp with g++ and
    portable flags (no -march=native: the library must load on whatever
    machine the checkout runs on). native/__init__.py loads it.

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

import torch

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
_launchers = None      # launcher name -> bound ctypes function
_error_string = None


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
    """Build and load the kernel library at the first call and bind every
    launcher once; returns the dict of bound launchers."""
    global _launchers, _error_string
    with _lock:
        if _launchers is None:
            lib = ctypes.CDLL(kernels_path())
            bound = {}
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
                bound[name] = fn
            lib.sa_error_string.argtypes = [ctypes.c_int]
            lib.sa_error_string.restype = ctypes.c_char_p
            _error_string = lib.sa_error_string
            _launchers = bound
        return _launchers


def launch(name: str, *args) -> None:
    """Call one launcher and raise if CUDA refused the launch. Pointers and
    the stream are plain ints (tensor.data_ptr(), stream_of). After the
    first call this takes no lock and looks nothing up in the library."""
    err = (_launchers or kernels())[name](*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{_error_string(err).decode()}")


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device. Read
    through torch._C: torch.cuda.current_stream(device).cuda_stream gives
    the same handle but builds a Stream object first, which costs more
    host time than the launch itself. torch._C._cuda_getCurrentRawStream is
    not a public name (verified with torch 2.11.0): if a later torch drops
    it, every launch raises AttributeError, and tests/test_torch_cuda.py
    holds it to the public handle, under a side stream too."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def native_lib_path() -> str:
    """Build the native host library (native/*.cpp) if its hash is new;
    return its path. native/__init__.py loads it from there."""
    srcs = sorted(glob.glob(os.path.join(_PKG, "native", "*.cpp")))
    out = os.path.join(BUILD_DIR, f"native-{_digest(srcs, GXX_FLAGS)}.so")
    with _lock:
        if not os.path.exists(out):
            _compile(["g++", *GXX_FLAGS], srcs, out)
    return out
