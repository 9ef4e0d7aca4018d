"""Barcode frequency cutoffs (host, parity-exact).

Two cutoff procedures exist in the reference and both have load-bearing
off-by-one behavior (SURVEY.md §2 #13/#16):

* barcode_hist + elbow_cutoff (extract_sr_bc, scTagger.py:386-395,483-494):
  the histogram entry at k*step is computed BEFORE subtracting the k*step-th
  barcode's count (covers the top k*step-1 barcodes), and the first step
  whose coverage increment falls below thresh is INCLUDED via
  last_idx = min(idx, n).

* chunked_cutoff (extract_sr_bc_from_lr, scTagger.py:828-835): iterate
  step_size chunks of the sorted counts, break on the first chunk whose share
  of total is below thresh, and keep sorted[:last_idx + step_size] — the
  failing chunk included.
"""

from __future__ import annotations


def barcode_hist(counts, total, step_size: int) -> dict[int, float]:
    """counts: iterable of (barcode, count) sorted descending."""
    remaining = total
    distribution: dict[int, float] = {}
    idx = 0
    for idx, (_b, c) in enumerate(counts, start=1):
        if idx % step_size == 0:
            distribution[idx] = 1 - remaining / total
        remaining -= c
    if idx and idx % step_size != 0:
        distribution[idx] = 1 - remaining / total
    return distribution


def elbow_cutoff(distribution: dict[int, float], n_barcodes: int, thresh: float) -> int:
    last_idx = n_barcodes
    last_f = 0.0
    for idx, f in sorted(distribution.items()):
        if idx == 0:
            continue
        if f - last_f < thresh:
            last_idx = min(idx, n_barcodes)
            break
        last_f = f
    return last_idx


def chunked_cutoff(sorted_counts, step_size: int, thresh: float):
    """sorted_counts: list of (key, count) sorted descending; returns the kept
    prefix including the first below-threshold chunk."""
    if not sorted_counts:
        return []
    total = sum(c for _k, c in sorted_counts)
    last_idx = 0
    for last_idx in range(0, len(sorted_counts), step_size):
        share = (
            sum(c for _k, c in sorted_counts[last_idx : last_idx + step_size])
            / total
        )
        if share < thresh:
            break
    return sorted_counts[: last_idx + step_size]
