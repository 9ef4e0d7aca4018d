"""BAM CB-tag extraction via the native C++ BGZF/BAM reader.

Replaces the reference's pysam/htslib dependency (scTagger.py:433-466). The
native reader streams the whole coordinate-sorted BAM sequentially — the same
record set pysam's per-contig fetch() yields, without needing a .bai index —
and counts barcodes with first-appearance ordering (== the reference's
Counter insertion order for its -t 1 sequential behavior; with more threads
the reference's equal-count ordering is nondeterministic, see SURVEY.md §7).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native.build import load

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _lib = load()
    return _lib


def extract_cb_counts(path: str) -> tuple[list[str], np.ndarray, int]:
    """Returns (barcodes in first-appearance order, counts, total kept records).

    total counts records mapped to a contig with flag <= 256 (including those
    without a usable CB tag, which contribute no barcode) — reference
    read_bam_contig semantics (scTagger.py:453-466).
    """
    lib = _get_lib()
    barcodes_p = ctypes.c_char_p()
    counts_p = ctypes.POINTER(ctypes.c_int64)()
    n_unique = ctypes.c_int64()
    total = ctypes.c_int64()
    error_p = ctypes.c_char_p()
    rc = lib.sctag_extract_cb(
        path.encode(),
        ctypes.byref(barcodes_p),
        ctypes.byref(counts_p),
        ctypes.byref(n_unique),
        ctypes.byref(total),
        ctypes.byref(error_p),
    )
    if rc != 0:
        msg = (error_p.value or b"unknown error").decode()
        lib.sctag_free(ctypes.cast(error_p, ctypes.c_void_p))
        raise RuntimeError(f"BAM read failed for {path}: {msg}")
    try:
        raw = barcodes_p.value or b""
        barcodes = raw.decode().split("\n")[:-1] if raw else []
        n = n_unique.value
        counts = np.ctypeslib.as_array(counts_p, shape=(n,)).copy() if n else (
            np.empty(0, dtype=np.int64)
        )
    finally:
        lib.sctag_free(ctypes.cast(barcodes_p, ctypes.c_void_p))
        lib.sctag_free(ctypes.cast(counts_p, ctypes.c_void_p))
    return barcodes, counts, total.value


class SelfSyncError(RuntimeError):
    """skip=-1 self-synchronization found no valid record boundary (e.g. a
    record larger than the probe window); callers fall back to the blocking
    spill handoff."""


def extract_cb_counts_range(
    path: str, comp_start: int, comp_end: int, skip: int, parse_header: bool,
    nthreads: int = 2,
):
    """Sharded scan for --n-hosts stage-2 execution: records starting in the
    compressed byte range [comp_start, comp_end) after dropping ``skip``
    spill bytes from the previous shard.

    ``skip == -1`` self-synchronizes instead of waiting for the upstream
    spill: the reader discovers the first record boundary by validating a
    chained record walk (bam_reader.cpp find_record_start) and reports the
    discovered offset, so all hosts inflate+parse concurrently and reconcile
    afterwards (stages/extract_sr_bc.py). Raises SelfSyncError if no
    boundary validates.

    Returns (barcodes, counts, firsts, total, n_kept_bc, spill, found_skip):
    ``firsts[i]`` = first LOCAL kept-barcode record index of barcodes[i]
    (callers add the earlier shards' kept counts to globalize);
    ``spill`` = uncompressed bytes this shard's final record(s) consumed past
    comp_end (the next shard's ``skip``); ``found_skip`` = the discovered
    boundary offset (equals ``skip`` when it was given explicitly >= 0)."""
    lib = _get_lib()
    barcodes_p = ctypes.c_char_p()
    counts_p = ctypes.POINTER(ctypes.c_int64)()
    firsts_p = ctypes.POINTER(ctypes.c_int64)()
    n_unique = ctypes.c_int64()
    total = ctypes.c_int64()
    kept = ctypes.c_int64()
    spill = ctypes.c_int64()
    found_skip = ctypes.c_int64()
    error_p = ctypes.c_char_p()
    rc = lib.sctag_extract_cb_range(
        path.encode(), comp_start, comp_end, skip,
        1 if parse_header else 0, nthreads,
        ctypes.byref(barcodes_p), ctypes.byref(counts_p),
        ctypes.byref(firsts_p), ctypes.byref(n_unique), ctypes.byref(total),
        ctypes.byref(kept), ctypes.byref(spill), ctypes.byref(found_skip),
        ctypes.byref(error_p),
    )
    if rc != 0:
        msg = (error_p.value or b"unknown error").decode()
        lib.sctag_free(ctypes.cast(error_p, ctypes.c_void_p))
        if rc == 2:
            raise SelfSyncError(f"BAM self-sync failed for {path}: {msg}")
        raise RuntimeError(f"BAM shard read failed for {path}: {msg}")
    try:
        raw = barcodes_p.value or b""
        barcodes = raw.decode().split("\n")[:-1] if raw else []
        n = n_unique.value
        counts = np.ctypeslib.as_array(counts_p, shape=(n,)).copy() if n else (
            np.empty(0, dtype=np.int64)
        )
        firsts = np.ctypeslib.as_array(firsts_p, shape=(n,)).copy() if n else (
            np.empty(0, dtype=np.int64)
        )
    finally:
        lib.sctag_free(ctypes.cast(barcodes_p, ctypes.c_void_p))
        lib.sctag_free(ctypes.cast(counts_p, ctypes.c_void_p))
        lib.sctag_free(ctypes.cast(firsts_p, ctypes.c_void_p))
    return (barcodes, counts, firsts, total.value, kept.value, spill.value,
            found_skip.value)


def bam_file_size(path: str) -> int:
    lib = _get_lib()
    n = lib.sctag_file_size(path.encode())
    if n < 0:
        raise RuntimeError(f"cannot stat {path}")
    return int(n)
