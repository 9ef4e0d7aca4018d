"""The alt stage's whitelist as one byte buffer: the file read whole, and
inflated when gzip (native/gz_inflate.cpp), with no string per line.

``read_whitelist(path)`` gives the words as rows of that buffer when every
line is k bytes and a newline (1 <= k <= 16), and None for any other file
(ragged, CRLF or lone-CR endings, no final newline, a blank line, empty): the
stage then reads the file's lines as the reference does. Bytes other than
ACGT pass here; build_key_table refuses them.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..observability import count
from .fastq import _NativeMem

MAX_K = 16  # the longest word a 2-bit key table packs in int64 beside its rc


class FixedStrideWords:
    """Words of k bytes, each followed by a newline, in one buffer: ``buf``
    the bytes, ``rows`` their (m, k + 1) uint8 view, ``words[i]`` word i as
    the reference's ``line[:-1]`` gives it."""

    def __init__(self, buf: np.ndarray, k: int):
        self.buf = buf
        self.k = k
        self.rows = buf.reshape(-1, k + 1)

    def __len__(self) -> int:
        return self.rows.shape[0]

    def __getitem__(self, i: int) -> str:
        return self.rows[i, : self.k].tobytes().decode("latin-1")


def read_bytes(path: str, gz: bool) -> np.ndarray:
    """The file's bytes, inflated when ``gz``, as a uint8 view of native
    memory that is freed with the last view of it. Raises OSError when the
    file cannot be read, or, with ``gz``, is not intact gzip."""
    from ..native import build as native_build

    lib = native_build.load()
    out = ctypes.c_void_p()
    n = ctypes.c_int64()
    err = ctypes.c_char_p()
    if lib.sctag_inflate_file(path.encode(), int(gz), ctypes.byref(out),
                              ctypes.byref(n), ctypes.byref(err)) != 0:
        msg = err.value.decode() if err.value else "unknown error"
        lib.sctag_free(err)
        raise OSError(f"{path}: {msg}")
    if n.value == 0:
        lib.sctag_free(out)
        return np.zeros(0, np.uint8)
    mem = (ctypes.c_ubyte * n.value).from_address(out.value)
    mem.owner = _NativeMem(lib, out)  # every numpy view holds ``mem``
    return np.frombuffer(mem, dtype=np.uint8)


def read_whitelist(path: str) -> FixedStrideWords | None:
    """The whitelist's words over one buffer, when its lines have one length
    (module note); gzip iff the path ends with .gz, as io.tsv.open_maybe_gz
    reads it. Counts ``whitelist.bytes``. Raises OSError as read_bytes."""
    buf = read_bytes(path, path.endswith(".gz"))
    count("whitelist.bytes", buf.size)
    nl = np.flatnonzero(buf[: MAX_K + 1] == ord("\n"))
    k = int(nl[0]) if nl.size else 0
    if k == 0 or buf.size % (k + 1):
        return None
    words = FixedStrideWords(buf, k)
    if not (words.rows[:, k] == ord("\n")).all():
        return None
    return words
