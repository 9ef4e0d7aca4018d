"""Bit-parallel Myers edit distance in plain torch (twins of
sctagger_tpu/ops/myers.py).

Same semantics as the JAX module: infix ("HW") distance, one int32 lane per
(text, pattern) pair, a Python loop over text positions in place of
``lax.scan``. Character codes 0..3 = A,C,G,T; any other code (4 = pad)
matches nothing. int32 arithmetic wraps in torch, which is the two's
complement behaviour the recurrences rely on (m = 32 puts the score bit at
the sign bit; it is read with an arithmetic shift and a mask, never a
comparison against a shifted constant).

These are the plain versions behind the CUDA kernels' wrappers
(ops/match_cuda.py, ops/adapter_cuda.py), the matcher's path for patterns
longer than 32 bp, tie-overflow escalation, and stage 1's mask fallback and
reverse-start recovery (models/adapter.py).
"""

from __future__ import annotations

import numpy as np
import torch

from sctagger_tpu.core.packing import CODE_PAD

MAX_PATTERN_LEN = 32


def high_bit(m: int) -> int:
    """Bit-(m-1) mask as a Python int valid for int32 (two's-complement wrap
    at m = 32)."""
    return int(np.int32(np.uint32(1 << (m - 1))))


# ---------------------------------------------------------------------------
# Peq construction (host-side numpy; copied from sctagger_tpu/ops/myers.py)
# ---------------------------------------------------------------------------

def build_peq_single(pattern_codes: np.ndarray) -> np.ndarray:
    """Peq table for one pattern: (5,) int32; bit i of Peq[c] = (pattern[i]==c)."""
    m = len(pattern_codes)
    assert 0 < m <= MAX_PATTERN_LEN, m
    peq = np.zeros(CODE_PAD + 1, dtype=np.int64)
    for i, c in enumerate(pattern_codes):
        if c < CODE_PAD:  # junk pattern chars match nothing
            peq[int(c)] |= 1 << i
    return peq.astype(np.int32)  # two's complement bit pattern preserved


def build_peq_multi(pattern_codes: np.ndarray) -> np.ndarray:
    """Peq table for P patterns: (5, P) int32 from (P, m) code array."""
    P, m = pattern_codes.shape
    assert 0 < m <= MAX_PATTERN_LEN, m
    peq = np.zeros((CODE_PAD + 1, P), dtype=np.int64)
    weights = (1 << np.arange(m, dtype=np.int64))[None, :]  # (1, m)
    for c in range(CODE_PAD):
        peq[c] = ((pattern_codes == c) * weights).sum(axis=1)
    return peq.astype(np.int32)


def n_words(m: int) -> int:
    return (m + 31) // 32


def build_peq_single_mw(pattern_codes: np.ndarray) -> np.ndarray:
    """(W, 5) int32 Peq for one pattern of any length."""
    m = len(pattern_codes)
    W = n_words(m)
    peq = np.zeros((W, CODE_PAD + 1), dtype=np.int64)
    for i, c in enumerate(pattern_codes):
        if c < CODE_PAD:
            peq[i // 32, int(c)] |= 1 << (i % 32)
    return peq.astype(np.int32)


def build_peq_multi_mw(pattern_codes: np.ndarray) -> np.ndarray:
    """(W, 5, P) int32 Peq for P patterns of uniform length m."""
    P, m = pattern_codes.shape
    W = n_words(m)
    peq = np.zeros((W, CODE_PAD + 1, P), dtype=np.int64)
    for w in range(W):
        bits = min(32, m - 32 * w)
        weights = (1 << np.arange(bits, dtype=np.int64))[None, :]
        chunk = pattern_codes[:, 32 * w : 32 * w + bits]
        for c in range(CODE_PAD):
            peq[w, c] = ((chunk == c) * weights).sum(axis=1)
    return peq.astype(np.int32)


# ---------------------------------------------------------------------------
# Core recurrence
# ---------------------------------------------------------------------------

def _step(pv, mv, score, eq, m: int, shw: bool = False):
    """One Myers column update (int32 tensors). Returns (pv, mv, score).

    ``shw=True`` is the prefix mode (leading text gap penalized) through the
    carry-in bit on Ph's shift, as in the JAX twin."""
    xv = eq | mv
    xh = (((eq & pv) + pv) ^ pv) | eq
    ph = mv | ~(xh | pv)
    mh = pv & xh
    score = score + ((ph >> (m - 1)) & 1) - ((mh >> (m - 1)) & 1)
    ph = ph << 1
    if shw:
        ph = ph | 1
    mh = mh << 1
    pv = mh | ~(xv | ph)
    mv = ph & xv
    return pv, mv, score


def _eq_table(peq: torch.Tensor) -> torch.Tensor:
    """(5, P) Peq -> (5, P) lookup table whose row 4 is zero: every code
    outside 0..3 selects it (the JAX select chain's 'matches nothing')."""
    tab = torch.zeros_like(peq)
    tab[:4] = peq[:4]
    return tab


def _eq_lookup(tab: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Eq = Peq[c]: tab (5, P) from _eq_table, c (R,) codes -> (R, P).
    Codes outside 0..3 select the zero row 4 (the JAX select chain gives 0
    for them)."""
    sel = torch.where((c >= 0) & (c < CODE_PAD), c, CODE_PAD).long()
    return tab[sel]


def match_best(seg_T: torch.Tensor, peq: torch.Tensor, m: int) -> torch.Tensor:
    """(R, P) int32 best infix distance of every pattern vs every segment.

    seg_T: (Ls, R) integer codes, position-major; peq: (5, P) int32."""
    tab = _eq_table(peq)
    shape = (seg_T.shape[1], peq.shape[1])
    dev = peq.device
    pv = torch.full(shape, -1, dtype=torch.int32, device=dev)
    mv = torch.zeros(shape, dtype=torch.int32, device=dev)
    score = torch.full(shape, m, dtype=torch.int32, device=dev)
    best = score.clone()
    for c in seg_T.to(dev):
        pv, mv, score = _step(pv, mv, score, _eq_lookup(tab, c), m)
        torch.minimum(best, score, out=best)
    return best


def match_block_min(seg_T: torch.Tensor, peq: torch.Tensor, m: int) -> torch.Tensor:
    """(R,) min infix distance over patterns and positions (pass 1)."""
    return match_best(seg_T, peq, m).amin(dim=1)


def scores_scan(text_T: torch.Tensor, peq: torch.Tensor, m: int, shw: bool = False):
    """Per-position last-row scores (twin of the JAX ``_scores_scan``).

    text_T: (L, B) integer codes, position-major; peq: (5,) one pattern for
    every lane, or (5, P). Returns (L, B) or (L, B, P) int32: scores[j] is
    D[m][j+1], the best distance of the pattern against text spans ending
    at position j. ``shw`` selects the prefix mode."""
    tab = _eq_table(peq)
    dev = peq.device
    shape = (*text_T.shape[1:], *peq.shape[1:])
    pv = torch.full(shape, -1, dtype=torch.int32, device=dev)
    mv = torch.zeros(shape, dtype=torch.int32, device=dev)
    score = torch.full(shape, m, dtype=torch.int32, device=dev)
    out = torch.empty((text_T.shape[0], *score.shape), dtype=torch.int32, device=dev)
    for j, c in enumerate(text_T.to(dev)):
        pv, mv, score = _step(pv, mv, score, _eq_lookup(tab, c), m, shw)
        out[j] = score
    return out


# ---------------------------------------------------------------------------
# Multi-word Myers (patterns longer than 32 bp)
# ---------------------------------------------------------------------------
# edlib-style carry chain between 32-bit words, as in the JAX module: the
# horizontal delta enters the next word through Eq (for -1) and the
# shifted-in bits of Ph/Mh; the score is read at bit (m-1) % 32 of the top
# word before the shift.

def _step_mw(pvs, mvs, score, eqs, m: int, shw: bool = False):
    """One multi-word column update. pvs/mvs/eqs: lists of W tensors."""
    W = len(pvs)
    r = (m - 1) % 32
    zero = torch.zeros_like(score)
    hp = torch.ones_like(score) if shw else zero
    hm = zero
    for w in range(W):
        pv, mv, eq = pvs[w], mvs[w], eqs[w]
        xv = eq | mv
        eq2 = eq | hm
        xh = (((eq2 & pv) + pv) ^ pv) | eq2
        ph = mv | ~(xh | pv)
        mh = pv & xh
        if w == W - 1:
            score = score + ((ph >> r) & 1) - ((mh >> r) & 1)
        hp_out = (ph >> 31) & 1
        hm_out = (mh >> 31) & 1
        ph = (ph << 1) | hp
        mh = (mh << 1) | hm
        pvs[w] = mh | ~(xv | ph)
        mvs[w] = ph & xv
        hp, hm = hp_out, hm_out
    return pvs, mvs, score


def _match_best_mw(seg_T: torch.Tensor, peq_w: torch.Tensor, m: int):
    """Multi-word (R, P) best-distance matrix with a streaming min."""
    W = peq_w.shape[0]
    tabs = [_eq_table(peq_w[w]) for w in range(W)]
    shape = (seg_T.shape[1], peq_w.shape[2])
    dev = peq_w.device
    pvs = [torch.full(shape, -1, dtype=torch.int32, device=dev) for _ in range(W)]
    mvs = [torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(W)]
    score = torch.full(shape, m, dtype=torch.int32, device=dev)
    best = score.clone()
    for c in seg_T.to(dev):
        eqs = [_eq_lookup(t, c) for t in tabs]
        pvs, mvs, score = _step_mw(pvs, mvs, score, eqs, m)
        torch.minimum(best, score, out=best)
    return best


def scores_scan_mw(text_T: torch.Tensor, peq_w: torch.Tensor, m: int, shw: bool = False):
    """Multi-word ``scores_scan`` (twin of the JAX ``_scores_scan_mw``):
    peq_w (W, 5) or (W, 5, P)."""
    W = peq_w.shape[0]
    tabs = [_eq_table(peq_w[w]) for w in range(W)]
    dev = peq_w.device
    shape = (*text_T.shape[1:], *peq_w.shape[2:])
    pvs = [torch.full(shape, -1, dtype=torch.int32, device=dev) for _ in range(W)]
    mvs = [torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(W)]
    score = torch.full(shape, m, dtype=torch.int32, device=dev)
    out = torch.empty((text_T.shape[0], *shape), dtype=torch.int32, device=dev)
    for j, c in enumerate(text_T.to(dev)):
        eqs = [_eq_lookup(t, c) for t in tabs]
        pvs, mvs, score = _step_mw(pvs, mvs, score, eqs, m, shw)
        out[j] = score
    return out


def match_block_min_mw(seg_T, peq_w, m: int) -> torch.Tensor:
    """Multi-word pass 1: (R,) min over patterns and positions."""
    return _match_best_mw(seg_T, peq_w, m).amin(dim=1)


def match_best_mw_t(seg_T, peq_w, m: int) -> torch.Tensor:
    """Multi-word best-distance matrix, transposed (P, R) int32."""
    return _match_best_mw(seg_T, peq_w, m).T
