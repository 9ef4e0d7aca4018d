"""What the stage modules share: reading outputs and comparing them."""

from __future__ import annotations

import gzip
import hashlib

import numpy as np


def read_text(path) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
    opener = gzip.open if head == b"\x1f\x8b" else open
    with opener(path, "rb") as f:
        return f.read()


def outputs_differ(outputs, last: bytes) -> int:
    """How many of the invocations' outputs differ from the last one."""
    want = hashlib.sha256(last).digest()
    return sum(hashlib.sha256(read_text(p)).digest() != want for p in outputs[:-1])


def rows_wrong(expected: list[bytes], observed: list[bytes]) -> int:
    """Rows that differ position by position, plus rows one side lacks."""
    n = min(len(expected), len(observed))
    bad = sum(a != b for a, b in zip(expected[:n], observed[:n]))
    return bad + abs(len(expected) - len(observed))


def lines(text: bytes) -> list[bytes]:
    out = text.split(b"\n")
    return out[:-1] if out and out[-1] == b"" else out


def sample_rows(n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed % (1 << 64), 99])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def verdict(**numbers) -> dict:
    return {k: {"value": int(v[0]), "limit": int(v[1])} for k, v in numbers.items()}
