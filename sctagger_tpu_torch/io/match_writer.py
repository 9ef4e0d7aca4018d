"""match_trie's output file, formatted and compressed on all host cores.

The rows are those of stages.match_trie._render_rows (reference
scTagger.py:777-790): matched reads only, ascending rid, ties joined by ','
with pattern id p = 2*bid + fwd printing rev_compl(bc) for even p. The
native writer (native/tsv_writer_mt.cpp) cuts them into blocks of about
``BLOCK_BYTES`` formatted bytes at row boundaries; a pool of
min(blocks, cores) threads formats each block and, for a path ending in
'gz' (match_trie's convention), deflates it at level 4 into one gzip
member; the members are written in row order. The cut depends on the rows
alone, so the file is the same bytes on any host. An output of one block
takes no pool.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..core.packing import _REV_COMPL_BYTES
from ..observability import count

BLOCK_BYTES = 2 << 20  # formatted bytes a block (and a gzip member) holds
LEVEL = 4


def _cores() -> int:
    """The host cores this process may run on."""
    return len(os.sched_getaffinity(0))


def write_match_tsv(path: str, names, segs, barcodes, result) -> bool:
    """Write ``result``'s rows to ``path``; False when the native writer
    cannot take the input (list[str] segments, non-latin-1 names, the
    library unavailable), and the caller renders the rows in Python.

    Counts ``write.members`` (gzip members, 0 for a plain file),
    ``write.threads`` and ``write.raw_bytes`` (the decompressed bytes)."""
    buf = getattr(segs, "buf", None)
    offs = getattr(segs, "offs", None)
    if buf is None or offs is None:
        return False
    try:
        from ..native import build as native_build

        lib = native_build.load()
    except Exception:
        return False
    rids = np.ascontiguousarray(result.rids, np.int64)
    m = rids.size
    try:
        blob = ("\n".join([names[r] for r in rids.tolist()]) + "\n").encode(
            "latin-1") if m else b""
    except UnicodeEncodeError:
        return False
    ends = np.flatnonzero(np.frombuffer(blob, np.uint8) == 10)
    if ends.size != m:  # a name holding '\n' (no TSV read gives one)
        return False
    name_offs = np.zeros(m + 1, np.int64)
    name_offs[1:] = ends + 1

    # pattern-id-indexed print blob: row p=2*bid is the revcomp, p=2*bid+1
    # the forward barcode (matcher pattern order, models/matcher.py:85-92)
    bl = len(barcodes[0]) if barcodes else 0
    fwd = np.frombuffer("".join(barcodes).encode("latin-1"), np.uint8).reshape(
        len(barcodes), bl)
    bc2 = np.zeros((2 * len(barcodes), bl), np.uint8)
    bc2[1::2] = fwd
    bc2[0::2] = _REV_COMPL_BYTES[fwd][:, ::-1]

    # ties: a row's slots, or for the rare row with more ties than slots its
    # overflow list, those lists concatenated in row order
    cnt = np.ascontiguousarray(result.tie_counts, np.int64)
    slots = np.ascontiguousarray(result.tie_slots, np.int64)
    K = slots.shape[1]
    long_rows = rids[cnt > K].tolist()
    overflow = np.concatenate(
        [np.asarray(result.overflow[r], np.int64) for r in long_rows]
        or [np.zeros(0, np.int64)])

    gz = path.endswith("gz")
    dists = np.ascontiguousarray(result.dists, np.int64)
    offs64 = np.ascontiguousarray(offs, np.int64)
    stats = np.zeros(3, np.int64)
    err = ctypes.c_char_p()
    rc = lib.sctag_write_match_tsv_mt(
        path.encode(), int(gz), LEVEL,
        blob, name_offs.ctypes.data,
        buf.ctypes.data, offs64.ctypes.data,
        rids.ctypes.data, m, dists.ctypes.data,
        cnt.ctypes.data, slots.ctypes.data, K, overflow.ctypes.data,
        bc2.tobytes(), bl, BLOCK_BYTES, _cores(),
        stats.ctypes.data, ctypes.byref(err),
    )
    if rc != 0:
        msg = err.value.decode() if err.value else "unknown error"
        lib.sctag_free(err)
        raise OSError(f"{path}: {msg}")
    count("write.members", int(stats[0]) if gz else 0)
    count("write.threads", int(stats[1]))
    count("write.raw_bytes", int(stats[2]))
    return True
