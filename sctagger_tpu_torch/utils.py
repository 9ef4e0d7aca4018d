"""Small shared helpers (copied from sctagger_tpu/utils/misc.py; host-side,
usable everywhere)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def full_fast(shape, value, dtype) -> np.ndarray:
    """np.full without the first-touch page-fault cliff.

    On this host, writing into freshly malloc-backed pages (np.empty/np.full)
    faults at ~500us/page — a brand-new 16 MB np.full costs ~0.5 s — while
    calloc-backed pages (np.zeros) fault fast (CLAUDE.md "page-fault cliff").
    zeros+fill is ~2 ms for the same array, every time.
    """
    out = np.zeros(shape, dtype)
    if value:
        out.fill(value)
    return out


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return cdiv(x, m) * m


def batch_iter(n: int, batch: int) -> Iterator[tuple[int, int]]:
    """Yield (start, stop) index pairs covering range(n) in chunks of ``batch``."""
    for s in range(0, n, batch):
        yield s, min(s + batch, n)


class _NullBar:
    def update(self, n: int = 1) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
