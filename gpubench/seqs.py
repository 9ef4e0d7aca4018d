"""Vectorised helpers for making sequence inputs and the text files a user
hands a stage. Bases are codes 0-3 (A, C, G, T); 4 pads a row past its
length. Nothing here loops over rows in Python."""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ASCII = np.frombuffer(b"ACGTN", np.uint8)  # code -> byte
PAD = 4


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def _pair_table() -> np.ndarray:
    """uint16 -> the ASCII of its two bytes' codes (codes above 4 read N)."""
    lut = np.concatenate([ASCII, np.full(251, ord("N"), np.uint8)])
    i = np.arange(1 << 16)
    lo, hi = lut[i & 0xFF].astype(np.uint16), lut[i >> 8].astype(np.uint16)
    return (lo | (hi << 8)) if np.little_endian else ((lo << 8) | hi)


def codes_to_ascii(codes: np.ndarray) -> np.ndarray:
    """ASCII bases of codes, two a lookup."""
    flat = np.ascontiguousarray(codes).reshape(-1)
    if flat.size % 2:
        return ASCII[codes]
    return _pair_table()[flat.view(np.uint16)].view(np.uint8).reshape(codes.shape)


def random_codes(rng, shape) -> np.ndarray:
    n = int(np.prod(shape))
    return (np.frombuffer(rng.bytes(n), np.uint8) & 3).reshape(shape)


def substitute(rng, codes: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``codes`` with every base under ``mask`` replaced by another base."""
    shift = rng.integers(1, 4, size=codes.shape, dtype=np.uint8)
    return np.where(mask, (codes + shift) & 3, codes).astype(np.uint8)


def pick_k_positions(rng, n: int, width: int, k: np.ndarray) -> np.ndarray:
    """(n, width) bool with exactly k[i] distinct True positions in row i."""
    order = np.argsort(rng.random((n, width)), axis=1)
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(width)[None, :], axis=1)
    return ranks < k[:, None]


def revcomp_rows(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse complement of each row's first lens[i] codes (pads stay)."""
    n, w = mat.shape
    j = np.arange(w)[None, :]
    src = lens[:, None] - 1 - j
    inside = src >= 0
    out = np.full_like(mat, PAD)
    got = np.take_along_axis(mat, np.where(inside, src, 0), axis=1)
    out[inside] = 3 - got[inside]
    return out


def keys_to_ascii(keys: np.ndarray, k: int) -> np.ndarray:
    """2-bit keys -> (n, k) ASCII bases, four bases a byte through a table."""
    table = ASCII[(np.arange(256)[:, None] >> np.array([6, 4, 2, 0])[None, :]) & 3]
    word = (keys.astype(np.uint64) << np.uint64(64 - 2 * k)).astype(">u8")
    return table[word.view(np.uint8).reshape(-1, 8)].reshape(-1, 32)[:, :k]


def keys_to_codes(keys: np.ndarray, k: int) -> np.ndarray:
    """2-bit keys (first base in the top bits) -> (n, k) codes."""
    shifts = (2 * np.arange(k - 1, -1, -1)).astype(np.uint64)
    return ((keys.astype(np.uint64)[:, None] >> shifts[None, :]) & 3).astype(np.uint8)


def codes_to_keys(codes: np.ndarray) -> np.ndarray:
    """(n, k) codes -> int64 keys, first base in the top bits."""
    k = codes.shape[1]
    shifts = (2 * np.arange(k - 1, -1, -1)).astype(np.int64)
    return (codes.astype(np.int64) << shifts[None, :]).sum(axis=1)


def unique_kmers(rng, n: int, k: int) -> np.ndarray:
    """n distinct random k-mers as int64 keys, in random order."""
    got = np.empty(0, np.int64)
    while got.size < n:
        draw = rng.integers(0, 1 << (2 * k), size=int((n - got.size) * 1.01) + 64,
                            dtype=np.int64)
        allk = np.concatenate([got, draw])
        _, first = np.unique(allk, return_index=True)
        got = allk[np.sort(first)]
    return got[:n]


def uuid_names(rng, n: int) -> np.ndarray:
    """(n, 36) uint8: random names in the 8-4-4-4-12 hex form of read ids."""
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    nib = rng.integers(0, 16, size=(n, 32), dtype=np.uint8)
    out = np.empty((n, 36), np.uint8)
    cols = [c for c in range(36) if c not in (8, 13, 18, 23)]
    out[:, cols] = hexd[nib]
    out[:, [8, 13, 18, 23]] = ord("-")
    return out


def int_field(vals: np.ndarray):
    """Decimal text of ints as a (n, w) uint8 field and its lengths."""
    v = np.asarray(vals, np.int64)
    neg = v < 0
    a = np.abs(v)
    ndig = np.maximum(1, np.floor(np.log10(np.maximum(a, 1))).astype(np.int64) + 1)
    ndig = np.where(a >= 10 ** ndig, ndig + 1, ndig)  # log10 rounding guard
    w = int((ndig + neg).max()) if v.size else 1
    lens = ndig + neg
    out = np.zeros((v.size, w), np.uint8)
    pos = np.arange(w)[None, :]
    # digit at column c (0-based, after the sign) is a // 10**(ndig-1-c) % 10
    c = pos - neg[:, None]
    power = np.clip(ndig[:, None] - 1 - c, 0, 18)
    digits = (a[:, None] // (10 ** power)) % 10
    out[:] = (ord("0") + digits).astype(np.uint8)
    out[neg, 0] = ord("-")
    return out, lens


def text_field(codes: np.ndarray, lens: np.ndarray):
    """A base field: (n, w) codes -> ASCII bytes, with its lengths."""
    return ASCII[codes], np.asarray(lens, np.int64)


def const_field(n: int, text: bytes):
    return (np.broadcast_to(np.frombuffer(text, np.uint8), (n, len(text))),
            np.full(n, len(text), np.int64))


def join_rows(fields) -> bytes:
    """TSV rows from (matrix, lengths) fields: each row is its fields'
    first lens[i] bytes joined by tabs and ended by a newline."""
    n = fields[0][0].shape[0]
    parts = []
    for i, (mat, lens) in enumerate(fields):
        parts.append((mat, lens))
        parts.append(const_field(n, b"\t" if i + 1 < len(fields) else b"\n"))
    width = sum(m.shape[1] for m, _ in parts)
    out = np.empty((n, width), np.uint8)
    keep = np.empty((n, width), bool)
    c = 0
    for mat, lens in parts:
        w = mat.shape[1]
        out[:, c:c + w] = mat
        keep[:, c:c + w] = np.arange(w)[None, :] < np.asarray(lens)[:, None]
        c += w
    return out[keep].tobytes()


GZ_BLOCK = 8 << 20


def _gz_member(block: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 31)  # 31: a gzip member
    return c.compress(block) + c.flush()


def write_gz(path, data, level: int = 1) -> None:
    """``data`` as a gzip file of one member per 8 MiB block, compressed on
    several threads (gzip readers read concatenated members as one
    stream)."""
    mv = memoryview(data).cast("B")
    blocks = [mv[i:i + GZ_BLOCK] for i in range(0, len(mv), GZ_BLOCK)] or [mv]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool, open(path, "wb") as f:
        for member in pool.map(lambda b: _gz_member(b, level), blocks):
            f.write(member)


def decode_rows(codes: np.ndarray, lens: np.ndarray) -> list[bytes]:
    """Rows of codes as bytes (for the few rows a check looks at)."""
    txt = ASCII[codes]
    return [txt[i, : int(lens[i])].tobytes() for i in range(codes.shape[0])]


def compact_rows(mat: np.ndarray, keep: np.ndarray):
    """Each row's kept entries moved to its front, in order, padded with
    PAD; returns (rows, lengths)."""
    order = np.argsort(~keep, axis=1, kind="stable")
    out = np.take_along_axis(mat, order, axis=1)
    lens = keep.sum(axis=1)
    out[np.arange(mat.shape[1])[None, :] >= lens[:, None]] = PAD
    return out, lens.astype(np.int64)


def edit_indel(rng, codes: np.ndarray, rate: float, weights):
    """Each base of each row edited with probability ``rate``: substituted,
    preceded by an inserted random base, or deleted, in the proportions of
    ``weights`` (sub, ins, del). Returns (rows, lengths) as compact_rows."""
    n, k = codes.shape
    w = np.asarray(weights, np.float64)
    p = np.concatenate([[1.0 - rate], rate * w / w.sum()])  # none, sub, ins, del
    ev = np.searchsorted(np.cumsum(p), rng.random((n, k)), side="right")
    ev = np.minimum(ev, 3)
    base = substitute(rng, codes, ev == 1)
    ins = random_codes(rng, (n, k))
    mat = np.stack([ins, base], axis=2).reshape(n, 2 * k)
    keep = np.stack([ev == 2, ev != 3], axis=2).reshape(n, 2 * k)
    return compact_rows(mat, keep)


def zipf_choice(rng, n_items: int, s: float, size: int) -> np.ndarray:
    """Ranks 0..n_items-1 drawn with probability proportional to 1/(r+1)**s."""
    w = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w / w.sum())
    return np.minimum(np.searchsorted(cdf, rng.random(size), side="right"),
                      n_items - 1)
