"""Build and bind the port's CUDA kernels (nvcc + ctypes).

Each source in ``sctagger_tpu_torch/csrc/`` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into its own library under ``build/sctagger_tpu_torch/`` at the repository
root, under a file name keyed by a hash of the source and flags, so an
edited source rebuilds. All missing libraries build at once, one nvcc
process per source. The libraries have a plain C interface (no PyTorch
headers), which keeps a build to seconds. Nothing here runs at import time;
a failed build raises.
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
_SRCS = {
    "match_full": _PKG / "csrc" / "match_full.cu",
    "adapter_scan": _PKG / "csrc" / "adapter_scan.cu",
    "myers_micro": _PKG / "csrc" / "myers_micro.cu",
}
BUILD_DIR = _PKG.parent / "build" / "sctagger_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp, _i32 = ctypes.c_void_p, ctypes.c_int
_MATCH_ARGS = [
    _vp, _i32, _i32,  # seg, ls, r_pad
    _vp, _i32,  # peq, p_pad
    _vp, _i32,  # maxlens, mlen_block
    _vp, _i32,  # target, m
    _i32, _vp, _vp,  # tiles_per_split, partial, out
    _vp,  # stream
]
# C signature of each entry point, by library
_SIGNATURES = {
    "match_full": {
        "sctag_match_full": _MATCH_ARGS,  # K1, K2
        "sctag_match_min": _MATCH_ARGS,  # K4
        "sctag_match_best": _MATCH_ARGS,  # K5
        "sctag_match_ties": _MATCH_ARGS,  # K3
    },
    "adapter_scan": {
        "sctag_adapter_scan": [
            _vp, _i32, _i32,  # text, b, row_bytes
            _vp, _vp, _i32,  # lens, peq (host), m
            _vp, _vp,  # out, stream
        ],
    },
    "myers_micro": {
        "sctag_myers_micro": [
            _vp, _i32, _i32,  # x, n, iters
            _i32, _i32,  # chains, grid
            _vp, _vp,  # out, stream
        ],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG = ""  # nvcc's output of the builds this process ran (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_SRCS[name].read_bytes())
    return BUILD_DIR / f"libsctag_{name}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns the library path of each source by name."""
    global BUILD_LOG
    todo = [name for name in _SRCS if not _lib_path(name).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRCS[name])]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((name, cmd, tmp, proc))
        logs, failed = [], []
        for name, cmd, tmp, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"[{name}] {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{name}: nvcc exited {proc.returncode}")
            else:  # atomic: a concurrent build never sees a partial file
                os.replace(tmp, _lib_path(name))
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"{'; '.join(failed)}\n{BUILD_LOG}")
    return {name: _lib_path(name) for name in _SRCS}


def build_host() -> pathlib.Path:
    """Build the g++ host library the port reuses from sctagger_tpu/native
    (FASTQ and TSV I/O, the prefilters); otherwise it builds at first use,
    inside whatever stage touches it first."""
    from sctagger_tpu.native import build as host

    return host.ensure_built()


def load(name: str) -> ctypes.CDLL:
    """The library of source ``name`` (a key of _SRCS), built on first use,
    with the C signatures of its entry points set."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build()[name]))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype = _i32
                fn.argtypes = argtypes
            _libs[name] = lib
        return _libs[name]
