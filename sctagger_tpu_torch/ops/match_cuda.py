"""The fused match kernel (csrc/match_full.cu): wrappers and plain versions.

Port of sctagger_tpu/ops/match_pallas.py's match_full_tpu /
match_full_dynls_tpu. The public layout is the JAX package's:

  seg_T    (Ls, R_pad) int8 codes, position-major, pad code 4
  peq_pm   (P_pad, 8) int32, pattern-major (columns 0..4 = Peq of codes
           0..4), P_pad a multiple of DEF_BP (zero rows score m)
  maxlens  (1, R_pad // br) int32: the sweep bound of each br-read block
  out      (TIES_K + 2, R_pad) int32: [0] min distance, [1] tie count,
           [2..] the first TIES_K tie pattern ids ascending (BIG = empty)

A wrapper given CPU tensors runs its plain version (``match_full_ref`` /
``match_full_dynls_ref``); given CUDA tensors it launches the kernel on the
current stream or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from sctagger_tpu.utils import cdiv, full_fast, round_up

from .myers import _match_best_mw, match_best

DEF_BR = 1024  # read-axis padding unit (and the maxlens block)
DEF_BP = 256  # pattern-axis padding unit (the kernel's shared Peq tile)
TIES_K = 8  # tie slots per read; overflow reads escalate in the matcher
BIG = 1 << 28

LAUNCHES = 0  # kernel launches by match_full / match_full_dynls

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

def tie_rows(seg_T: torch.Tensor, n_pat: int, m: int, best_fn) -> torch.Tensor:
    """(TIES_K + 2, R) kernel rows from a tiled best-distance matrix.

    ``best_fn(seg, p0, p1)`` returns the (r, p1 - p0) int32 best distances of
    patterns [p0, p1) against the reads of ``seg``. Pattern tiles are merged
    in ascending order with the kernel's rule: the running min starts at m,
    an improving tile resets count and slots, and its first hits are
    appended after the slots already filled.
    """
    R = seg_T.shape[1]
    dev = seg_T.device
    out = torch.empty((TIES_K + 2, R), dtype=torch.int32, device=dev)
    pos = torch.arange(TIES_K, device=dev)
    for r0 in range(0, R, _R_TILE):
        seg = seg_T[:, r0 : r0 + _R_TILE]
        rt = seg.shape[1]
        d = torch.full((rt,), m, dtype=torch.int32, device=dev)
        cnt = torch.zeros((rt,), dtype=torch.int32, device=dev)
        slots = torch.full((rt, TIES_K), BIG, dtype=torch.int32, device=dev)
        for p0 in range(0, n_pat, _P_TILE):
            p1 = min(p0 + _P_TILE, n_pat)
            best = best_fn(seg, p0, p1)
            bmin = best.amin(dim=1)
            improved = bmin < d
            d = torch.minimum(d, bmin)
            hits = best == d[:, None]
            cnt = torch.where(improved, 0, cnt)
            slots = torch.where(improved[:, None], BIG, slots)
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
        out[0, r0 : r0 + rt] = d
        out[1, r0 : r0 + rt] = cnt
        out[2:, r0 : r0 + rt] = slots.T
    return out


def match_full_ref(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """Plain torch version of match_full (any device)."""
    peq = peq_pm[:, :5].T.contiguous()  # (5, P_pad)
    return tie_rows(
        seg_T, peq.shape[1], m,
        lambda seg, p0, p1: match_best(seg, peq[:, p0:p1], m),
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


def _launch(seg_T, peq_pm, maxlens, m: int) -> torch.Tensor:
    global LAUNCHES
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

    n_tiles = p_pad // DEF_BP
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # split the pattern axis until the grid holds ~_BLOCKS_PER_SM blocks/SM
    want = cdiv(_BLOCKS_PER_SM * n_sm, cdiv(r_pad, _THREADS))
    tiles_per_split = cdiv(n_tiles, max(1, min(n_tiles, want)))
    n_split = cdiv(n_tiles, tiles_per_split)

    out = torch.empty((TIES_K + 2, r_pad), dtype=torch.int32, device=dev)
    partial = (
        torch.empty((n_split, TIES_K + 2, r_pad), dtype=torch.int32, device=dev)
        if n_split > 1
        else None
    )
    lib = _build.load("match_full")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sctag_match_full(
            seg_T.data_ptr(), ls, r_pad, peq_pm.data_ptr(), p_pad,
            ml_ptr, mlen_block, m, tiles_per_split,
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"sctag_match_full launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _route(seg_T: torch.Tensor) -> str:
    if seg_T.device.type in ("cpu", "cuda"):
        return seg_T.device.type
    raise ValueError(f"no match kernel for device {seg_T.device}")


def match_full(seg_T: torch.Tensor, peq_pm: torch.Tensor, m: int) -> torch.Tensor:
    """Fused min + ties over all patterns (K1). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if _route(seg_T) == "cpu":
        return match_full_ref(seg_T, peq_pm, m)
    return _launch(seg_T, peq_pm, None, m)


def match_full_dynls(
    seg_T: torch.Tensor, peq_pm: torch.Tensor, maxlens: torch.Tensor, m: int
) -> torch.Tensor:
    """match_full with each read block's sweep stopped at its maxlens entry
    (K2); bit-identical to match_full when maxlens bounds the real lengths."""
    if _route(seg_T) == "cpu":
        return match_full_dynls_ref(seg_T, peq_pm, maxlens, m)
    return _launch(seg_T, peq_pm, maxlens, m)
