"""The match kernels (csrc/match_full.cu): wrappers and plain versions.

Port of sctagger_tpu/ops/match_pallas.py's four match kernels, which share
one Myers sweep and differ in their epilogue. The public layouts are the
JAX package's:

  seg_T    (Ls, R_pad) int8 codes, position-major, pad code 4
  peq_pm   (P_pad, 8) int32, pattern-major (columns 0..4 = Peq of codes
           0..4), P_pad a multiple of DEF_BP (zero rows score m)
  maxlens  (1, R_pad // br) int32: the sweep bound of each br-read block
  target   (R_pad,) int32: the distance match_ties collects hits at

  match_full / match_full_dynls (K1, K2)  (TIES_K + 2, R_pad) int32:
           [0] min distance, [1] tie count, [2..] the first TIES_K tie
           pattern ids ascending (BIG = empty)
  match_min (K4)   (1, R_pad) int32: the min distance
  match_best (K5)  (P_pad, R_pad) int8: min(best distance, 127) per pair
  match_ties (K3)  (TIES_K + 1, R_pad) int32: [0] number of patterns at
           distance target[r], [1..] the first TIES_K of them ascending

A wrapper given CPU tensors runs its plain version (``*_ref``); given CUDA
tensors it launches the kernel on the calling thread's current stream or
raises. Each wrapper counts its kernel launches: ``LAUNCHES`` (match_full
and match_full_dynls), ``MIN_LAUNCHES``, ``BEST_LAUNCHES``,
``TIES_LAUNCHES``, under a lock, so the counts stay exact when two threads
launch (the checkpointed match_trie runs two batches at once).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..utils import cdiv, full_fast, round_up

from .myers import _match_best_mw
from .myers import match_best as _myers_best

DEF_BR = 1024  # read-axis padding unit (and the maxlens block)
DEF_BP = 256  # pattern-axis padding unit (the kernel's shared Peq tile)
TIES_K = 8  # tie slots per read; overflow reads escalate in the matcher
BIG = 1 << 28

LAUNCHES = 0  # kernel launches by match_full / match_full_dynls
MIN_LAUNCHES = 0  # by match_min
BEST_LAUNCHES = 0  # by match_best
TIES_LAUNCHES = 0  # by match_ties
_COUNT_LOCK = threading.Lock()

_THREADS = 128  # reads per CUDA block (csrc/match_full.cu THREADS)
_BLOCKS_PER_SM = 16  # pattern-axis split target: ~2 waves of resident blocks
_P_TILE = 4096  # plain version: patterns per step (bounds its memory)
_R_TILE = 8192  # plain version: reads per step


def prep_peq_cols(peq_5p: np.ndarray, bp: int = DEF_BP) -> np.ndarray:
    """(5, P) Peq -> pattern-major (P_pad, 8) int32 for the kernel."""
    P = peq_5p.shape[1]
    out = np.zeros((round_up(max(P, 1), bp), 8), dtype=np.int32)
    out[:P, :5] = peq_5p.T
    return out


def prep_segs_T(seg_codes: np.ndarray, ls: int, br: int = DEF_BR) -> np.ndarray:
    """(R, L) uint8 codes -> position-major (ls, R_pad) int8, pad code 4,
    R_pad = R rounded up to a whole ``br`` block."""
    R = seg_codes.shape[0]
    out = full_fast((ls, round_up(max(R, 1), br)), 4, np.int8)
    out[: min(ls, seg_codes.shape[1]), :R] = seg_codes.T[:ls]
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def tie_rows(
    seg_T: torch.Tensor, n_pat: int, m: int, best_fn, target=None
) -> torch.Tensor:
    """Kernel rows from a tiled best-distance matrix.

    ``best_fn(seg, p0, p1)`` returns the (r, p1 - p0) int32 best distances of
    patterns [p0, p1) against the reads of ``seg``. Without ``target`` the
    rows are match_full's (TIES_K + 2, R): pattern tiles are merged in
    ascending order with the kernel's rule, the running min starts at m, an
    improving tile resets count and slots, and its first hits are appended
    after the slots already filled. With ``target`` (R,) the distance is
    fixed and the rows are match_ties' (TIES_K + 1, R): every tile's hits
    add to the count and append to the slots.
    """
    R = seg_T.shape[1]
    dev = seg_T.device
    head = 2 if target is None else 1  # rows before the slots
    out = torch.empty((TIES_K + head, R), dtype=torch.int32, device=dev)
    pos = torch.arange(TIES_K, device=dev)
    for r0 in range(0, R, _R_TILE):
        seg = seg_T[:, r0 : r0 + _R_TILE]
        rt = seg.shape[1]
        if target is None:
            d = torch.full((rt,), m, dtype=torch.int32, device=dev)
        else:
            d = target[r0 : r0 + rt].to(dev, torch.int32)
        cnt = torch.zeros((rt,), dtype=torch.int32, device=dev)
        slots = torch.full((rt, TIES_K), BIG, dtype=torch.int32, device=dev)
        for p0 in range(0, n_pat, _P_TILE):
            p1 = min(p0 + _P_TILE, n_pat)
            best = best_fn(seg, p0, p1)
            if target is None:
                bmin = best.amin(dim=1)
                improved = bmin < d
                d = torch.minimum(d, bmin)
                cnt = torch.where(improved, 0, cnt)
                slots = torch.where(improved[:, None], BIG, slots)
            hits = best == d[:, None]
            ids = torch.where(
                hits,
                torch.arange(p0, p1, dtype=torch.int32, device=dev),
                BIG,
            )
            # ids are distinct apart from BIG, so the k smallest, sorted,
            # are the first hits in ascending order (no tie-order reliance)
            k = min(TIES_K, p1 - p0)
            new = torch.full((rt, TIES_K), BIG, dtype=torch.int32, device=dev)
            new[:, :k] = ids.topk(k, dim=1, largest=False, sorted=True).values
            ff = cnt.clamp(max=TIES_K)[:, None]
            src = torch.where(pos < ff, pos, TIES_K + pos - ff)
            slots = torch.cat([slots, new], dim=1).gather(1, src)
            cnt = cnt + hits.sum(dim=1, dtype=torch.int32)
        if target is None:
            out[0, r0 : r0 + rt] = d
        out[head - 1, r0 : r0 + rt] = cnt
        out[head:, r0 : r0 + rt] = slots.T
    return out


def _peq_5p(peq_pm: torch.Tensor) -> torch.Tensor:
    """(P_pad, 8) pattern-major Peq -> the (5, P_pad) table of ops/myers."""
    return peq_pm[:, :5].T.contiguous()


def match_full_ref(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """Plain torch version of match_full (any device)."""
    peq = _peq_5p(peq_pm)
    return tie_rows(
        seg_T, peq.shape[1], m,
        lambda seg, p0, p1: _myers_best(seg, peq[:, p0:p1], m),
    )


def match_full_dynls_ref(
    seg_T: torch.Tensor, peq_pm: torch.Tensor, maxlens: torch.Tensor, m: int
) -> torch.Tensor:
    """Plain torch version of match_full_dynls: each read block's sweep stops
    at its maxlens entry (rows past it are masked to pad code 4, which is
    what stopping the sweep means for an infix distance)."""
    ls, R = seg_T.shape
    br = R // maxlens.numel()
    bound = maxlens.reshape(-1).repeat_interleave(br).to(seg_T.device)
    rows = torch.arange(ls, device=seg_T.device)[:, None]
    cut = torch.where(rows < bound[None, :], seg_T, torch.full_like(seg_T, 4))
    return match_full_ref(cut, peq_pm, m)


def match_full_mw_ref(seg_T: torch.Tensor, peq_w: torch.Tensor, m: int) -> torch.Tensor:
    """Kernel rows for patterns longer than 32 bp (multi-word Peq
    (W, 5, P)); no kernel exists for them, on any device."""
    return tie_rows(
        seg_T, peq_w.shape[2], m,
        lambda seg, p0, p1: _match_best_mw(seg, peq_w[:, :, p0:p1], m),
    )


def _best_tiles(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int):
    """(r0, p0, best) for each tile of the (R, P_pad) int32 best-distance
    matrix, _R_TILE reads by _P_TILE patterns (bounds the plain versions'
    memory)."""
    peq = _peq_5p(peq_pm)
    for r0 in range(0, seg_T.shape[1], _R_TILE):
        seg = seg_T[:, r0 : r0 + _R_TILE]
        for p0 in range(0, peq.shape[1], _P_TILE):
            yield r0, p0, _myers_best(seg, peq[:, p0 : p0 + _P_TILE], m)


def match_min_ref(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """Plain torch version of match_min (any device): the running min over
    pattern tiles, starting from m."""
    out = torch.full((1, seg_T.shape[1]), m, dtype=torch.int32, device=seg_T.device)
    for r0, _, best in _best_tiles(seg_T, peq_pm, m):
        row = out[0, r0 : r0 + best.shape[0]]
        torch.minimum(row, best.amin(dim=1), out=row)
    return out


def match_best_ref(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """Plain torch version of match_best (any device): (P_pad, R) int8."""
    out = torch.empty((peq_pm.shape[0], seg_T.shape[1]), dtype=torch.int8,
                      device=seg_T.device)
    for r0, p0, best in _best_tiles(seg_T, peq_pm, m):
        out[p0 : p0 + best.shape[1], r0 : r0 + best.shape[0]] = (
            best.clamp(max=127).to(torch.int8).T
        )
    return out


def match_ties_ref(
    seg_T: torch.Tensor, peq_pm: torch.Tensor, target: torch.Tensor, m: int
) -> torch.Tensor:
    """Plain torch version of match_ties (any device)."""
    peq = _peq_5p(peq_pm)
    return tie_rows(
        seg_T, peq.shape[1], m,
        lambda seg, p0, p1: _myers_best(seg, peq[:, p0:p1], m),
        target=target,
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, ndim: int, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: expected {ndim}-d {dtype}, got {t.dim()}-d {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def split_of(dev, r_pad: int, p_pad: int) -> tuple[int, int]:
    """(tiles_per_split, n_split) of a launch: the pattern axis is split
    over blockIdx.y until the grid holds ~_BLOCKS_PER_SM blocks per SM."""
    n_tiles = p_pad // DEF_BP
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    want = cdiv(_BLOCKS_PER_SM * n_sm, cdiv(r_pad, _THREADS))
    tiles_per_split = cdiv(n_tiles, max(1, min(n_tiles, want)))
    return tiles_per_split, cdiv(n_tiles, tiles_per_split)


_ROWS = {"full": TIES_K + 2, "min": 1, "ties": TIES_K + 1}  # int32 out rows


def _launch(kind: str, seg_T, peq_pm, m: int, maxlens=None, target=None) -> torch.Tensor:
    """Launch the sweep with epilogue ``kind`` (full, min, best or ties)."""
    from . import _build

    dev = seg_T.device
    _check(seg_T, "seg_T", torch.int8, 2, dev)
    _check(peq_pm, "peq_pm", torch.int32, 2, dev)
    ls, r_pad = seg_T.shape
    p_pad = peq_pm.shape[0]
    if peq_pm.shape[1] != 8 or p_pad == 0 or p_pad % DEF_BP:
        raise ValueError(f"peq_pm must be (k*{DEF_BP}, 8), got {tuple(peq_pm.shape)}")
    if peq_pm.data_ptr() % 16:
        raise ValueError("peq_pm must be 16-byte aligned")
    if not 1 <= m <= 32:
        raise ValueError(f"pattern length {m} outside 1..32")
    if r_pad == 0:
        raise ValueError("seg_T has no reads")
    ml_ptr, mlen_block = None, 1
    if maxlens is not None:
        _check(maxlens, "maxlens", torch.int32, 2, dev)
        nb = maxlens.numel()
        if nb == 0 or r_pad % nb:
            raise ValueError(f"maxlens has {nb} blocks for {r_pad} reads")
        ml_ptr, mlen_block = maxlens.data_ptr(), r_pad // nb
    tg_ptr = None
    if target is not None:
        _check(target, "target", torch.int32, 1, dev)
        if target.numel() != r_pad:
            raise ValueError(f"target has {target.numel()} entries for {r_pad} reads")
        tg_ptr = target.data_ptr()

    tiles_per_split, n_split = split_of(dev, r_pad, p_pad)
    partial = None
    if kind == "best":
        out = torch.empty((p_pad, r_pad), dtype=torch.int8, device=dev)
    else:
        rows = _ROWS[kind]
        out = torch.empty((rows, r_pad), dtype=torch.int32, device=dev)
        if n_split > 1:
            partial = torch.empty((n_split, rows, r_pad), dtype=torch.int32, device=dev)
    fn = getattr(_build.load("match_full"), f"sctag_match_{kind}")
    # the range names the launch in a torch.profiler trace (SCTAG_PROFILE)
    with torch.profiler.record_function(f"sctag_match_{kind}"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            seg_T.data_ptr(), ls, r_pad, peq_pm.data_ptr(), p_pad,
            ml_ptr, mlen_block, tg_ptr, m, tiles_per_split,
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"sctag_match_{kind} launch failed: cudaError {err}")
    return out


def _count(name: str) -> None:
    """Add one launch to the counter ``name`` (a module global)."""
    with _COUNT_LOCK:
        globals()[name] += 1


def _route(seg_T: torch.Tensor) -> str:
    if seg_T.device.type in ("cpu", "cuda"):
        return seg_T.device.type
    raise ValueError(f"no match kernel for device {seg_T.device}")


def match_full(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """Fused min + ties over all patterns (K1). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if _route(seg_T) == "cpu":
        return match_full_ref(seg_T, peq_pm, m)
    out = _launch("full", seg_T, peq_pm, m)
    _count("LAUNCHES")
    return out


def match_full_dynls(
    seg_T: torch.Tensor, peq_pm: torch.Tensor, maxlens: torch.Tensor, m: int
) -> torch.Tensor:
    """match_full with each read block's sweep stopped at its maxlens entry
    (K2); bit-identical to match_full when maxlens bounds the real lengths."""
    if _route(seg_T) == "cpu":
        return match_full_dynls_ref(seg_T, peq_pm, maxlens, m)
    out = _launch("full", seg_T, peq_pm, m, maxlens=maxlens)
    _count("LAUNCHES")
    return out


def match_min(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """Min infix distance per read over all patterns, (1, R_pad) (K4)."""
    if _route(seg_T) == "cpu":
        return match_min_ref(seg_T, peq_pm, m)
    out = _launch("min", seg_T, peq_pm, m)
    _count("MIN_LAUNCHES")
    return out


def match_best(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """The best-distance matrix, (P_pad, R_pad) int8 clamped at 127 (K5)."""
    if _route(seg_T) == "cpu":
        return match_best_ref(seg_T, peq_pm, m)
    out = _launch("best", seg_T, peq_pm, m)
    _count("BEST_LAUNCHES")
    return out


def match_ties(
    seg_T: torch.Tensor, peq_pm: torch.Tensor, target: torch.Tensor, m: int
) -> torch.Tensor:
    """Per read, the number of patterns whose best distance is target[r]
    and the first TIES_K of them ascending, (TIES_K + 1, R_pad) (K3)."""
    if _route(seg_T) == "cpu":
        return match_ties_ref(seg_T, peq_pm, target, m)
    out = _launch("ties", seg_T, peq_pm, m, target=target)
    _count("TIES_LAUNCHES")
    return out
