"""Key counting + frequency ordering on the host (copied from
sctagger_tpu/ops/topk_count.py: ``count_and_rank_host`` only, the function
the alt stage calls).

Replaces the reference's Counter + sorted() (scTagger.py:826-828): ids
ranked by (count desc, first occurrence asc), exactly Python's stable
``sorted(..., key=count, reverse=True)`` over an insertion-ordered Counter.
"""

from __future__ import annotations

import numpy as np


def count_and_rank_host(keys: np.ndarray, valid: np.ndarray | None = None):
    """Host numpy twin of count_and_rank (identical order) — the production
    path (see module note). keys: (N,) uint32 ids."""
    if valid is not None:
        keys = keys[valid]
    n = keys.shape[0]
    if n == 0:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    k64 = keys.astype(np.int64)
    cnt = np.bincount(k64)
    uniq, fidx = np.unique(k64, return_index=True)
    nz = uniq
    order = np.lexsort((fidx, -cnt[nz]))
    ranked = nz[order]
    return ranked.astype(np.uint32), cnt[ranked].astype(np.int64)
