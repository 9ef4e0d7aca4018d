"""Build and bind the port's CUDA kernels (nvcc + ctypes).

The sources in ``sctagger_tpu_torch/csrc/`` are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``build/sctagger_tpu_torch/`` at the repository root, under a file name
keyed by a hash of the sources and flags, so an edited source rebuilds. The
library has a plain C interface (no PyTorch headers), which keeps the build
to seconds. Nothing here runs at import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRCS = [_PKG / "csrc" / "match_full.cu"]
BUILD_DIR = _PKG.parent / "build" / "sctagger_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_LOG = ""  # nvcc's output of the build this process ran (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsctag_match_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless a library for their hash exists."""
    global BUILD_LOG
    path = _lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _SRCS)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}"
        )
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    return path


def build_host() -> pathlib.Path:
    """Build the g++ host library the port reuses from sctagger_tpu/native
    (TSV parse and write, the prefilter's range search); otherwise it builds
    at first use, inside whatever stage touches it first."""
    from sctagger_tpu.native import build as host

    return host.ensure_built()


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.sctag_match_full.restype = i32
            lib.sctag_match_full.argtypes = [
                vp, i32, i32,  # seg, ls, r_pad
                vp, i32,  # peq, p_pad
                vp, i32, i32,  # maxlens, mlen_block, m
                i32, vp, vp,  # tiles_per_split, partial, out
                vp,  # stream
            ]
            _lib = lib
        return _lib
