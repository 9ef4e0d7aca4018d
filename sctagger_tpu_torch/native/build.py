"""Build/load the port's native host library (BGZF+BAM reader, FASTQ
reader/packer, TSV reader and writers, the pattern-range search, the host
adapter prefilters, the whitelist hash table and its threaded probe, the
whole-file gzip inflate, the threaded match TSV writer).

The sources in this directory are copies of the JAX package's
(``sctagger_tpu/native``), but for the port's own ``gz_inflate.cpp`` and
``tsv_writer_mt.cpp``. They
compile with g++ (plain C ABI + ctypes) at first use into
``build/sctagger_tpu_torch/`` at the repository root, under a file name
keyed by a hash of the sources and flags, so an edited source rebuilds and
this library is never the JAX package's file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

_DIR = pathlib.Path(__file__).resolve().parent
_SRCS = [
    _DIR / "bam_reader.cpp",
    _DIR / "fastq_reader.cpp",
    _DIR / "tsv_reader.cpp",
    _DIR / "hash_table.cpp",
    _DIR / "exact_probe.cpp",
    _DIR / "tsv_writer.cpp",
    _DIR / "tsv_writer_mt.cpp",
    _DIR / "range_search.cpp",
    _DIR / "adapter_d0.cpp",
    _DIR / "adapter_d1.cpp",
    _DIR / "gz_inflate.cpp",
]
_HDRS = [_DIR / "adapter_verify.h"]  # hashed, not compiled directly
BUILD_DIR = _DIR.parents[1] / "build" / "sctagger_tpu_torch"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None  # the loaded library


def lib_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in _SRCS + _HDRS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsctag_io_{h.hexdigest()[:16]}.so"


def ensure_built() -> pathlib.Path:
    """Compile the library unless it exists; returns its path."""
    lib = lib_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    base = ["g++", *GXX_FLAGS, *map(str, _SRCS), "-o", tmp, "-lz"]
    try:
        # libdeflate (when present) speeds up the BGZF inflate and the gz TSV
        # writer; the sources detect the header, so the probe is whether the
        # linker finds it
        try:
            subprocess.run(base + ["-ldeflate"], check=True, capture_output=True,
                           text=True)
        except subprocess.CalledProcessError:
            subprocess.run(base + ["-DSCTAG_NO_LIBDEFLATE"], check=True,
                           capture_output=True, text=True)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load():
    """The library (built on first use) with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(ensure_built()))
            _set_signatures(lib)
            _lib = lib
        return _lib


def _set_signatures(lib) -> None:
    lib.sctag_extract_cb.restype = ctypes.c_int
    lib.sctag_extract_cb.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.sctag_extract_cb_range.restype = ctypes.c_int
    lib.sctag_extract_cb_range.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,                     # comp_start
        ctypes.c_int64,                     # comp_end (-1 = EOF)
        ctypes.c_int64,                     # skip (prev range's spill)
        ctypes.c_int,                       # parse_header
        ctypes.c_int,                       # nthreads
        ctypes.POINTER(ctypes.c_char_p),    # barcodes
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),  # counts
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),  # firsts
        ctypes.POINTER(ctypes.c_int64),     # n_unique
        ctypes.POINTER(ctypes.c_int64),     # total
        ctypes.POINTER(ctypes.c_int64),     # n_kept_bc
        ctypes.POINTER(ctypes.c_int64),     # spill
        ctypes.POINTER(ctypes.c_int64),     # found_skip (self-sync)
        ctypes.POINTER(ctypes.c_char_p),    # error
    ]
    lib.sctag_file_size.restype = ctypes.c_int64
    lib.sctag_file_size.argtypes = [ctypes.c_char_p]
    lib.sctag_hash_build.restype = None
    lib.sctag_hash_build.argtypes = [
        ctypes.c_void_p,  # keys (uint32*)
        ctypes.c_void_p,  # vals (int32*)
        ctypes.c_int64,   # n
        ctypes.c_int64,   # size (power of two)
        ctypes.c_void_p,  # tkeys out
        ctypes.c_void_p,  # tvals out (pre-filled with INT32_MIN)
    ]
    lib.sctag_probe_rows.restype = None
    lib.sctag_probe_rows.argtypes = [
        ctypes.c_void_p,  # seq_buf
        ctypes.c_void_p,  # offs
        ctypes.c_int64,   # n_rows
        ctypes.c_void_p,  # tkeys
        ctypes.c_void_p,  # tvals
        ctypes.c_int64,   # tsize
        ctypes.c_int,     # k
        ctypes.c_int,     # nthreads
        ctypes.c_void_p,  # out_counts
        ctypes.c_void_p,  # out_single
    ]
    lib.sctag_read_fastq.restype = ctypes.c_int
    lib.sctag_read_fastq.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),    # names_buf
        ctypes.POINTER(ctypes.c_int64),     # names_len
        ctypes.POINTER(ctypes.c_int64),     # n_names
        ctypes.POINTER(ctypes.c_char_p),    # seq_buf
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),  # seq_offs
        ctypes.POINTER(ctypes.c_int64),     # n_seqs
        ctypes.POINTER(ctypes.c_int64),     # n_lines
        ctypes.POINTER(ctypes.c_char_p),    # error
    ]
    lib.sctag_encode_rows.restype = None
    lib.sctag_encode_rows.argtypes = [
        ctypes.c_void_p,                    # seq_buf (numpy data pointer)
        ctypes.c_void_p,                    # offs
        ctypes.c_void_p,                    # idx
        ctypes.c_int64,                     # n_idx
        ctypes.c_void_p,                    # table (256 bytes)
        ctypes.c_ubyte,                     # pad_code
        ctypes.c_int64,                     # pad_to
        ctypes.c_void_p,                    # out
    ]
    lib.sctag_encode_rows_packed.restype = None
    lib.sctag_encode_rows_packed.argtypes = [
        ctypes.c_void_p,                    # seq_buf
        ctypes.c_void_p,                    # offs
        ctypes.c_void_p,                    # idx
        ctypes.c_int64,                     # n_idx
        ctypes.c_void_p,                    # table (256 bytes)
        ctypes.c_int64,                     # pad_to (multiple of 4)
        ctypes.c_void_p,                    # out (n_idx x pad_to/4)
        ctypes.c_void_p,                    # junk_out (n_idx bytes)
    ]
    lib.sctag_read_lr_tsv.restype = ctypes.c_int
    lib.sctag_read_lr_tsv.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.sctag_gather_rows.restype = None
    lib.sctag_gather_rows.argtypes = [
        ctypes.c_void_p,  # seq_buf
        ctypes.c_void_p,  # offs
        ctypes.c_void_p,  # idx
        ctypes.c_int64,   # n_idx
        ctypes.c_void_p,  # out_buf
        ctypes.c_void_p,  # out_offs
    ]
    lib.sctag_fastq_stream_open.restype = ctypes.c_void_p
    lib.sctag_fastq_stream_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.sctag_fastq_stream_next.restype = ctypes.c_int
    lib.sctag_fastq_stream_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.sctag_fastq_stream_close.restype = None
    lib.sctag_fastq_stream_close.argtypes = [ctypes.c_void_p]
    lib.sctag_write_lr_tsv_gz.restype = ctypes.c_int
    lib.sctag_write_lr_tsv_gz.argtypes = [
        ctypes.c_char_p,                    # path
        ctypes.c_char_p,                    # names blob ('\n'-joined)
        ctypes.c_int64,                     # names_len
        ctypes.c_int64,                     # n rows
        ctypes.c_void_p,                    # dist (int64*)
        ctypes.c_void_p,                    # loc (int64*)
        ctypes.c_void_p,                    # valid (uint8*)
        ctypes.c_void_p,                    # seg_ptr (uint64* addresses)
        ctypes.c_void_p,                    # seg_len (int64*)
        ctypes.c_int,                       # gzip level
        ctypes.POINTER(ctypes.c_char_p),    # error
    ]
    lib.sctag_write_match_tsv.restype = ctypes.c_int
    lib.sctag_write_match_tsv.argtypes = [
        ctypes.c_char_p,                    # path
        ctypes.c_int,                       # gz (0/1)
        ctypes.c_int,                       # level
        ctypes.c_char_p,                    # names blob (matched rows)
        ctypes.c_int64,                     # names_len
        ctypes.c_void_p,                    # seg_buf (full arena)
        ctypes.c_void_p,                    # seg_offs (int64*, absolute)
        ctypes.c_void_p,                    # rids (int64*)
        ctypes.c_int64,                     # m matched rows
        ctypes.c_void_p,                    # dists (int64*)
        ctypes.c_void_p,                    # tie_offs (int64*, m+1)
        ctypes.c_void_p,                    # ties_flat (int64*)
        ctypes.c_char_p,                    # bc_blob (2N x bl)
        ctypes.c_int64,                     # bl
        ctypes.POINTER(ctypes.c_char_p),    # error
    ]
    lib.sctag_write_match_tsv_mt.restype = ctypes.c_int
    lib.sctag_write_match_tsv_mt.argtypes = [
        ctypes.c_char_p,                    # path
        ctypes.c_int,                       # gz (0/1)
        ctypes.c_int,                       # level
        ctypes.c_char_p,                    # names blob (matched rows)
        ctypes.c_void_p,                    # name_offs (int64*, m+1)
        ctypes.c_void_p,                    # seg_buf (full arena)
        ctypes.c_void_p,                    # seg_offs (int64*, absolute)
        ctypes.c_void_p,                    # rids (int64*)
        ctypes.c_int64,                     # m matched rows
        ctypes.c_void_p,                    # dists (int64*)
        ctypes.c_void_p,                    # tie_counts (int64*, m)
        ctypes.c_void_p,                    # tie_slots (int64*, m x k)
        ctypes.c_int64,                     # k
        ctypes.c_void_p,                    # overflow ties (int64*)
        ctypes.c_char_p,                    # bc_blob (2N x bl)
        ctypes.c_int64,                     # bl
        ctypes.c_int64,                     # block_bytes
        ctypes.c_int,                       # cores
        ctypes.c_void_p,                    # stats out (int64*, 3)
        ctypes.POINTER(ctypes.c_char_p),    # error
    ]
    lib.sctag_range_search_u64.restype = None
    lib.sctag_range_search_u64.argtypes = [
        ctypes.c_void_p,  # table (uint64*)
        ctypes.c_int64,   # n_table
        ctypes.c_void_p,  # off (int64*, n_buckets+1)
        ctypes.c_int,     # shift
        ctypes.c_void_p,  # q (uint64*)
        ctypes.c_int64,   # n_q
        ctypes.c_int,     # nthreads
        ctypes.c_void_p,  # out_lo (int64*)
        ctypes.c_void_p,  # out_cnt (int32*)
    ]
    lib.sctag_adapter_d0.restype = None
    lib.sctag_adapter_d0.argtypes = [
        ctypes.c_void_p,   # buf (uint8*)
        ctypes.c_void_p,   # offs (int64*, n+1)
        ctypes.c_int64,    # n
        ctypes.c_void_p,   # table (256 bytes)
        ctypes.c_uint64,   # key_fwd
        ctypes.c_uint64,   # key_rc
        ctypes.c_int,      # m
        ctypes.c_int,      # kmax
        ctypes.c_int,      # nthreads
        ctypes.c_void_p,   # fwd_cnt (int32*)
        ctypes.c_void_p,   # rc_cnt (int32*)
        ctypes.c_void_p,   # ends (int64*, n x 2*kmax)
    ]
    lib.sctag_adapter_scan1.restype = None
    lib.sctag_adapter_scan1.argtypes = [
        ctypes.c_void_p,   # buf (uint8*)
        ctypes.c_void_p,   # offs (int64*, n+1)
        ctypes.c_int64,    # n
        ctypes.c_void_p,   # table (256 bytes)
        ctypes.c_void_p,   # pat_fwd (m uint8 codes)
        ctypes.c_void_p,   # pat_rc (m uint8 codes)
        ctypes.c_int,      # m
        ctypes.c_int,      # kmax
        ctypes.c_int,      # nthreads
        ctypes.c_void_p,   # f0 (int32*)
        ctypes.c_void_p,   # r0 (int32*)
        ctypes.c_void_p,   # f1 (int32*)
        ctypes.c_void_p,   # r1 (int32*)
        ctypes.c_void_p,   # ends0 (int64*, n x 2*kmax)
        ctypes.c_void_p,   # ends1 (int64*, n x 2*kmax)
        ctypes.c_void_p,   # flags (uint8*)
    ]
    lib.sctag_inflate_file.restype = ctypes.c_int
    lib.sctag_inflate_file.argtypes = [
        ctypes.c_char_p,                    # path
        ctypes.c_int,                       # gz (0: the file's bytes)
        ctypes.POINTER(ctypes.c_void_p),    # out
        ctypes.POINTER(ctypes.c_int64),     # out_len
        ctypes.POINTER(ctypes.c_char_p),    # error
    ]
    lib.sctag_free.restype = None
    lib.sctag_free.argtypes = [ctypes.c_void_p]
