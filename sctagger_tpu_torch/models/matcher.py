"""Stage-3 matcher: dense LR-segment x whitelist infix matching (torch port
of sctagger_tpu/models/matcher.py).

Every segment is matched against the forward and reverse complement of every
barcode (pattern p = 2*bid + 1 forward, 2*bid reverse complement, so
ascending p is the reference's (bid, strand) tie order). Reads resolved at
distance <= 1 by the host prefilter (ops/exact_prefilter.py) never reach the
device; the rest are length-sorted, repacked into chunks of up to
PASS1_CHUNK reads, and swept by the fused kernel (ops/match_cuda.py), whose
rows carry each read's min distance, tie count and first TIES_K tie ids.
Reads with more than TIES_K ties escalate to a full best matrix
(match_best) and a top-k over it.

One dispatch loop serves every device: on CUDA the kernels run, on the CPU
their plain versions (the same rows). With several devices
(parallel/mesh.py) each chunk splits over the (data, model) grid and the
slices merge exactly; escalation stays on the first device. Patterns longer
than 32 bp take the multi-word plain version on one device (the kernels are
single-word).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ..core.packing import (
    CODE_PAD,
    LENIENT_TABLE,
    encode_rows,
    encode_seqs,
    rev_compl,
    seq_lengths,
)
from ..observability import span
from ..ops.match_cuda import (
    BIG,
    DEF_BP,
    DEF_BR,
    TIES_K,
    match_best,
    match_full,
    match_full_dynls,
    match_full_mw_ref,
    prep_peq_cols,
    prep_segs_T,
)
from ..ops.myers import (
    MAX_PATTERN_LEN,
    build_peq_multi,
    build_peq_multi_mw,
    match_best_mw_t,
)
from ..parallel.mesh import local_mesh, shard_match_full, shard_match_full_mp
from ..runtime import resolve_device
from ..utils import batch_iter, full_fast

PASS1_CHUNK = 131072  # reads per kernel launch
PASS2_CHUNK = 2048  # reads per escalation best matrix
TOPK_INIT = 16
MAX_PENDING = 4  # chunks in flight on the device before the host drains one


@dataclasses.dataclass
class MatchResult:
    """Per-read match output for matched reads only (reference omits the rest).

    Tie sets are stored as fixed-width arrays (no per-read Python objects):
    row i of ``tie_slots`` holds the first min(tie_counts[i], K) tie pattern
    ids ascending; reads with more ties than K have their full sorted id list
    in ``overflow`` keyed by rid. Pattern id p = 2*bid + (1 if forward).
    Slot values past tie_counts[i] are unspecified (BIG today) — consume via
    ``ties_of``/``tie_counts``, never raw slot comparisons.
    """

    rids: np.ndarray  # (M,) int64 read ids, ascending
    dists: np.ndarray  # (M,) int32 min edit distance (<= max_error)
    tie_counts: np.ndarray  # (M,) int64
    tie_slots: np.ndarray  # (M, K) int64
    overflow: dict[int, np.ndarray]

    def ties_of(self, i: int) -> np.ndarray:
        c = int(self.tie_counts[i])
        if c <= self.tie_slots.shape[1]:
            return self.tie_slots[i, :c]
        return self.overflow[int(self.rids[i])]


class MatchContext:
    """Whitelist-derived state reused across calls: the interleaved pattern
    codes (2N, bl), the Peq table ((5, 2N), or (W, 5, 2N) when bl > 32) and
    the d1 neighborhood index, built once on a worker thread."""

    def __init__(self, barcodes: Sequence[str], pat_codes=None, peq=None):
        self.barcodes = list(barcodes)
        self.bl = len(self.barcodes[0])
        if pat_codes is None:
            pat_codes = _build_patterns(self.barcodes, self.bl)
        self.pat_codes = np.asarray(pat_codes)
        if peq is None:
            peq = (
                build_peq_multi_mw(self.pat_codes)
                if self.bl > MAX_PATTERN_LEN
                else build_peq_multi(self.pat_codes)
            )
        self._peq = np.asarray(peq)
        self._nb_lock = threading.Lock()
        self._nb_thread = None
        self._nb_box: dict = {}

    @classmethod
    def from_arrays(cls, barcodes, pat_codes, peq) -> "MatchContext":
        """A context on given tables, e.g. a sctagger_tpu MatchContext's
        ``.pat_codes`` and ``.peq()``, so both packages match on one table."""
        return cls(barcodes, pat_codes=pat_codes, peq=peq)

    def peq(self) -> np.ndarray:
        return self._peq

    def start_nb_build(self) -> None:
        """Kick off the neighborhood-table build on a worker thread
        (idempotent)."""
        with self._nb_lock:
            if self._nb_thread is not None:
                return
            from ..ops.exact_prefilter import NeighborhoodIndex

            def _build() -> None:
                try:
                    with span("match.nb_build"):
                        self._nb_box["idx"] = NeighborhoodIndex(self.pat_codes)
                except BaseException as e:  # re-raised by nb_index()
                    self._nb_box["err"] = e

            self._nb_thread = threading.Thread(
                target=_build, daemon=True, name="match.nb_build"
            )
            self._nb_thread.start()

    def nb_index(self):
        self.start_nb_build()
        self._nb_thread.join()
        if "err" in self._nb_box:
            raise self._nb_box["err"]
        return self._nb_box["idx"]

    def nb_ready(self) -> bool:
        """Non-blocking: True iff the neighborhood index finished building."""
        t = self._nb_thread
        return t is not None and not t.is_alive() and "idx" in self._nb_box


def _build_patterns(barcodes: Sequence[str], bl: int) -> np.ndarray:
    """Interleaved (2N, bl) lenient code array: p=2*bid rc, p=2*bid+1 fwd."""
    pats: list[str] = []
    for b in barcodes:
        pats.append(rev_compl(b))  # strand False first (sort order)
        pats.append(b)
    codes, _ = encode_seqs(pats, pad_to=bl, table=LENIENT_TABLE)
    return codes


def _cat_codes(parts: list[np.ndarray]) -> np.ndarray:
    """Row-concatenate code arrays of different widths (pad code 4)."""
    width = max(p.shape[1] for p in parts)
    if all(p.shape[1] == width for p in parts):
        return np.concatenate(parts)
    out = full_fast((sum(p.shape[0] for p in parts), width), CODE_PAD, np.uint8)
    r = 0
    for p in parts:
        out[r : r + p.shape[0], : p.shape[1]] = p
        r += p.shape[0]
    return out


def prefilter_tiers(bl: int, lengths: np.ndarray) -> tuple[bool, bool]:
    """(prefilter, d1): whether the host prefilter takes reads of these
    ``lengths`` against ``bl``-bp patterns, and whether with its dist-1
    tier. It takes single-word patterns when the longest read is at most
    max(4 bl, 256); the dist-1 tier needs bl <= 31 (its bl + 1 keys fit 64
    bits)."""
    prefilter = (
        bl <= MAX_PATTERN_LEN
        and lengths.size > 0
        and int(lengths.max()) <= max(4 * bl, 256)
    )
    return prefilter, prefilter and bl <= 31


def match_segments(
    segments: Sequence[str],
    barcodes: Sequence[str],
    max_error: int,
    progress: bool = False,
    ctx: MatchContext | None = None,
    device=None,
    stats=None,
) -> MatchResult:
    """Match every segment against fwd+rc of every barcode within max_error.

    ``device`` is where the sweep runs (default: runtime.default_device()).
    ``stats`` (an observability StageStats) receives the read counts of the
    prefilter, the device sweep and the > TIES_K escalation
    (``escalated_reads``), and the main thread's time waiting for
    host prep (``match.prep_wait``), dispatching chunks to the device
    (``match.dispatch``), waiting for the device (``match.device_wait``)
    and in tie assembly (``match.ties``). The prep worker's time
    (``match.prep``) and the neighborhood build's (``match.nb_build``) go to
    the running stage (observability.span)."""
    dev = resolve_device(device)

    def _timer(key: str):
        return stats.timer(key) if stats is not None else span(key)

    if ctx is None:
        ctx = MatchContext(barcodes)
    bl = ctx.bl
    pat_codes = ctx.pat_codes
    mw = bl > MAX_PATTERN_LEN
    peq = ctx.peq()
    n_pat = pat_codes.shape[0]

    n = len(segments)
    lengths = seq_lengths(segments)
    min_dist = full_fast(n, bl, np.int32)
    order = np.argsort(lengths, kind="stable")

    # ---- host dist<=1 prefilter (ops/exact_prefilter.py) ------------------
    # Reads whose min distance is 0 or 1 have their complete tie set found on
    # the host, so only the min>1 remainder occupies the device. Output
    # identical by construction.
    prefilter, d1 = prefilter_tiers(bl, lengths)
    exact_pairs: list[tuple[np.ndarray, np.ndarray]] = []  # (rids, pids)
    # device_chunks_ragged: chunks swept by the ragged entry (K2); sweep_cells:
    # the read positions the sweep steps through, per pattern, and
    # sweep_pad_cells those past a read's own length (up to its block's
    # longest read, and the pad reads of a chunk's last block)
    counts = {"prefilter_resolved": 0, "prefilter_d1_resolved": 0,
              "device_reads": 0, "device_chunks": 0, "device_chunks_ragged": 0,
              "sweep_cells": 0, "sweep_pad_cells": 0}

    def _take_exact(sub: np.ndarray, ex) -> np.ndarray | None:
        """Record a probe result (rids local to ``sub``); returns the local
        keep-mask, or None when nothing hit. ``ex`` is ExactHits (all dist 0)
        or D1Hits (per-read dist 0/1)."""
        if ex.rids.size == 0:
            return None
        g = sub[ex.rids]
        cnts = np.diff(ex.offsets)
        dists = getattr(ex, "dists", None)
        if dists is None:
            min_dist[g] = 0
            gm, cm, pids = g, cnts, ex.pids
        else:
            min_dist[g] = dists
            counts["prefilter_d1_resolved"] += int(np.count_nonzero(dists == 1))
            ok = dists <= max_error  # mr=0: dist-1 reads resolve unmatched
            gm = g[ok]
            cm = cnts[ok]
            pids = ex.pids[np.repeat(ok, cnts)]
        if gm.size:
            exact_pairs.append((np.repeat(gm, cm), pids))
        counts["prefilter_resolved"] += int(ex.rids.size)
        keep = np.ones(sub.size, bool)
        keep[ex.rids] = False
        return keep

    from ..ops.exact_prefilter import exact_tie_probe

    if d1:
        # the neighborhood build runs on a worker thread behind the first
        # chunk; the first slice takes the cheap exact probe instead
        ctx.start_nb_build()

    # ---- slices of the length-sorted reads, each encoded at its own max
    # length; the probe mode of each (see the JAX matcher's streaming
    # layout): with d1 the first slice gets the exact probe, without it the
    # first slice ships unprobed ---------------------------------------------
    slices: list[tuple[np.ndarray, str]] = []
    for i, (s, e) in enumerate(batch_iter(order.size, PASS1_CHUNK)):
        if prefilter and (d1 or i > 0):
            mode = "exact" if (i == 0 and d1) else "full"
        else:
            mode = "none"
        slices.append((order[s:e], mode))

    def _prep(sub: np.ndarray, mode: str):
        with span("match.prep"):
            ls = int(lengths[sub].max(initial=0)) or 1
            codes, _ = encode_rows(segments, sub, pad_to=ls, table=LENIENT_TABLE)
            if mode == "none":
                return codes, None
            if mode == "exact" or not d1:
                return codes, exact_tie_probe(codes, lengths[sub], pat_codes)
        nb = ctx.nb_index()  # waits for the index build (match.nb_build)
        with span("match.prep"):
            return codes, nb.probe(codes, lengths[sub])

    # ---- device sweep ------------------------------------------------------
    # A process with several usable devices splits every chunk over a
    # (data, model) grid (parallel/mesh.py): reads over 'data', and under
    # SCTAG_MODEL_PARALLEL the patterns over 'model' with the exact tie
    # merge. One device: the one-device dispatch, the same rows either way.
    mesh = None if mw else local_mesh(divisor=PASS1_CHUNK // DEF_BR, device=dev)
    dp = mesh.shape["data"] if mesh is not None else 1
    mp = mesh.shape["model"] if mesh is not None else 1
    if mw:
        peq_dev = torch.from_numpy(peq).to(dev)
    elif mesh is not None:
        # pattern rows split over 'model' in whole kernel tiles
        peq_dev = torch.from_numpy(prep_peq_cols(peq, bp=mp * DEF_BP)).to(
            mesh.devices[0][0]
        )
    else:
        peq_dev = torch.from_numpy(prep_peq_cols(peq)).to(dev)
    chunks: list[tuple[np.ndarray, np.ndarray]] = []  # (sub, codes)
    tie_by_chunk: list[np.ndarray | None] = []
    pending: deque = deque()  # (chunk index, rows, ready event or None)

    def _drain(limit: int) -> None:
        while len(pending) > limit:
            ci, rows, ready = pending.popleft()
            with _timer("match.device_wait"):
                if ready is not None:
                    ready.synchronize()
            out = rows.numpy()[:, : chunks[ci][0].size]
            min_dist[chunks[ci][0]] = out[0]
            tie_by_chunk[ci] = out[1:]

    def _dispatch(sub: np.ndarray, codes: np.ndarray) -> None:
        with _timer("match.dispatch"):
            ll = lengths[sub]
            ls = int(ll.max()) or 1
            # on a grid, reads pad to whole DEF_BR blocks on every data slice
            seg_T = prep_segs_T(codes, ls=ls, br=DEF_BR * dp)
            ml = None
            if ll.min() != ll.max():
                # ragged chunk: each DEF_BR block stops at its own max length
                ml = np.zeros(seg_T.shape[1], np.int32)
                ml[: sub.size] = ll
                ml = torch.from_numpy(ml.reshape(1, -1, DEF_BR).max(axis=2))
            if mesh is not None:
                shard = shard_match_full if mp == 1 else shard_match_full_mp
                rows = shard(mesh, torch.from_numpy(seg_T), peq_dev, bl, maxlens=ml)
            else:
                seg_d = torch.from_numpy(seg_T).to(dev, non_blocking=True)
                if mw:
                    rows = match_full_mw_ref(seg_d, peq_dev, bl)
                elif ml is None:
                    rows = match_full(seg_d, peq_dev, bl)
                else:
                    rows = match_full_dynls(seg_d, peq_dev, ml.to(dev), bl)
            ready = None
            if rows.device.type == "cuda":
                # copy into pinned memory behind the kernel on the same stream,
                # so draining this chunk never waits for chunks queued after it
                with torch.cuda.device(rows.device):
                    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                    host.copy_(rows, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(rows.device))
                rows = host
            chunks.append((sub, codes))
            tie_by_chunk.append(None)
            pending.append((len(chunks) - 1, rows, ready))
            cells = seg_T.size if ml is None else int(ml.sum()) * DEF_BR
            counts["device_reads"] += int(sub.size)
            counts["device_chunks"] += 1
            counts["device_chunks_ragged"] += ml is not None
            counts["sweep_cells"] += cells
            counts["sweep_pad_cells"] += cells - int(ll.sum())
            _drain(MAX_PENDING)

    # Streaming layout: one worker thread encodes + probes slice i+1 while
    # the main thread applies slice i's probe result, repacks the survivors
    # into full chunks and dispatches them. Results are applied strictly in
    # slice order, so the output is that of the serial form.
    prep_pool = ThreadPoolExecutor(1, thread_name_prefix="match.prep")
    prep_q: deque = deque()
    PREP_DEPTH = 2
    try:
        nxt = 0
        while nxt < min(PREP_DEPTH, len(slices)):
            prep_q.append(prep_pool.submit(_prep, *slices[nxt]))
            nxt += 1
        carry_sub: list[np.ndarray] = []
        carry_codes: list[np.ndarray] = []
        carry_pend: list[bool] = []  # exact-only entries awaiting d1
        carry_n = 0

        def _reprobe_carry() -> None:
            # carried survivors of the exact-only first slice get the d1
            # probe once the index is ready (never waiting for it);
            # output-identical, since probe tiers are output-invisible
            nonlocal carry_n
            if not any(carry_pend) or not ctx.nb_ready():
                return
            for i, pend in enumerate(carry_pend):
                if not pend:
                    continue
                carry_pend[i] = False
                sub_i = carry_sub[i]
                if sub_i.size == 0:
                    continue
                keep = _take_exact(
                    sub_i, ctx.nb_index().probe(carry_codes[i], lengths[sub_i])
                )
                if keep is not None:
                    carry_sub[i] = sub_i[keep]
                    carry_codes[i] = carry_codes[i][keep]
                    carry_n -= int(sub_i.size - carry_sub[i].size)

        for sub, mode in slices:
            with _timer("match.prep_wait"):
                codes, ex = prep_q.popleft().result()
            if nxt < len(slices):
                prep_q.append(prep_pool.submit(_prep, *slices[nxt]))
                nxt += 1
            if ex is not None:
                keep = _take_exact(sub, ex)
                if keep is not None:
                    sub = sub[keep]
                    codes = codes[keep]
            carry_sub.append(sub)
            carry_codes.append(codes)
            carry_pend.append(mode == "exact")
            carry_n += sub.size
            if carry_n >= PASS1_CHUNK:
                _reprobe_carry()
            if carry_n >= PASS1_CHUNK:
                sub_all = np.concatenate(carry_sub)
                codes_all = _cat_codes(carry_codes)
                while sub_all.size >= PASS1_CHUNK:
                    _dispatch(sub_all[:PASS1_CHUNK], codes_all[:PASS1_CHUNK])
                    sub_all = sub_all[PASS1_CHUNK:]
                    codes_all = codes_all[PASS1_CHUNK:]
                carry_sub, carry_codes = [sub_all], [codes_all]
                carry_pend = [False]
                carry_n = sub_all.size
        _reprobe_carry()
        if carry_n:
            _dispatch(np.concatenate(carry_sub), _cat_codes(carry_codes))
    finally:
        prep_pool.shutdown(wait=False, cancel_futures=True)
    _drain(0)

    if progress:
        print(
            f"[match] {counts['prefilter_resolved']}/{n} reads resolved by the "
            f"host prefilter; {counts['device_reads']} reads in "
            f"{counts['device_chunks']} chunks on {dev.type}"
            + (f" over a {dp} x {mp} (data x model) grid" if mesh is not None else ""),
            file=sys.stderr,
        )

    with _timer("match.ties"):
        matched = np.flatnonzero(min_dist <= max_error)

        # ---- tie sets for matched reads (fixed-width arrays) --------------
        M = matched.size
        tie_counts = np.zeros(M, dtype=np.int64)
        tie_slots = np.zeros((M, TIES_K), dtype=np.int64)
        overflow: dict[int, np.ndarray] = {}
        overflow_meta: list[tuple[int, np.ndarray]] = []

        if exact_pairs:
            # prefilter-resolved reads: CSR tie sets in the kernel rows' layout
            # (first TIES_K ascending; the full set in overflow when larger).
            # Slices hold disjoint reads with pids ascending per read, so a
            # stable sort by read restores the global CSR.
            er = np.concatenate([p[0] for p in exact_pairs])
            ep = np.concatenate([p[1] for p in exact_pairs])
            srt = np.argsort(er, kind="stable")
            er, ep = er[srt], ep[srt]
            erids, cnts = np.unique(er, return_counts=True)
            offsets = np.zeros(erids.size + 1, np.int64)
            np.cumsum(cnts, out=offsets[1:])
            rows = np.searchsorted(matched, erids)
            tie_counts[rows] = cnts
            pos = offsets[:-1, None] + np.arange(TIES_K)[None, :]
            msk = np.arange(TIES_K)[None, :] < cnts[:, None]
            vals = ep[np.minimum(pos, ep.size - 1)]
            tie_slots[rows] = np.where(msk, vals, BIG)
            for i in np.flatnonzero(cnts > TIES_K):
                overflow[int(erids[i])] = ep[offsets[i] : offsets[i + 1]]

        for ci, (sub, codes) in enumerate(chunks):
            out = tie_by_chunk[ci]
            mrows = np.flatnonzero(min_dist[sub] <= max_error)
            if mrows.size == 0:
                continue
            msub = sub[mrows]
            rows = np.searchsorted(matched, msub)
            tie_counts[rows] = out[0][mrows]
            tie_slots[rows] = out[1:].T[mrows]
            for r in np.flatnonzero(out[0][mrows] > TIES_K):
                overflow_meta.append((int(msub[r]), codes[mrows[r]]))

        if overflow_meta:
            _escalate_ties(overflow_meta, peq, min_dist, bl, n_pat, overflow, dev)
        counts["escalated_reads"] = len(overflow_meta)

    if stats is not None:
        for k, v in counts.items():
            stats.count(k, v)
    return MatchResult(
        rids=matched.astype(np.int64),
        dists=min_dist[matched],
        tie_counts=tie_counts,
        tie_slots=tie_slots,
        overflow=overflow,
    )


def _escalate_ties(overflow_meta, peq, min_dist, bl, n_pat, overflow, dev) -> None:
    """Reads whose tie set exceeds TIES_K: full best matrix + tie lists on
    ``dev``, PASS2_CHUNK reads at a time (such reads are rare)."""
    ls = max(c.shape[0] for _, c in overflow_meta)
    codes = full_fast((len(overflow_meta), ls), CODE_PAD, np.uint8)
    for i, (_rid, c) in enumerate(overflow_meta):
        codes[i, : c.shape[0]] = c
    rids = np.array([o[0] for o in overflow_meta], dtype=np.int64)
    for s, e in batch_iter(rids.size, PASS2_CHUNK):
        best_t = _best_matrix_t(codes[s:e], peq, bl, dev)
        _collect_ties(best_t, min_dist[rids[s:e]], rids[s:e], n_pat, overflow)


def _topk_hits(best_t: torch.Tensor, target: torch.Tensor, n_pat: int, k: int):
    """best_t: (P, Rc) int8; target: (Rc,) int32.

    Returns (cnt (Rc,), idx (Rc, k)): hit count per read and the first k hit
    pattern ids in ascending order. Hit ids are distinct and misses map to
    BIG, so the k smallest sorted values are exactly those ids, whatever
    order topk keeps among equal values."""
    hits = best_t[:n_pat, :].to(torch.int32).T == target[:, None]
    cnt = hits.sum(dim=1)
    ids = torch.where(
        hits, torch.arange(n_pat, dtype=torch.int64, device=hits.device), BIG
    )
    idx = ids.topk(k, dim=1, largest=False, sorted=True).values
    return cnt, idx


def _collect_ties(best_t, target_np, sub, n_pat: int, ties: dict) -> None:
    """Per-read argmin tie sets from a best matrix, widening k once for the
    reads whose tie set overflows the first pass."""
    target = torch.from_numpy(np.ascontiguousarray(target_np, np.int32)).to(
        best_t.device
    )
    k = min(TOPK_INIT, n_pat)
    cnt, idx = _topk_hits(best_t, target, n_pat, k)
    cnt = cnt.cpu().numpy()
    idx = idx.cpu().numpy()
    for r in range(sub.size):
        c = int(cnt[r])
        if c <= k:
            ties[int(sub[r])] = idx[r, :c].astype(np.int64)
    over = np.flatnonzero(cnt > k)
    if over.size:
        # cnt is exact, so k = max(cnt) covers every overflowing read
        k = int(cnt[over].max())
        _, idx2 = _topk_hits(best_t, target, n_pat, k)
        idx2 = idx2.cpu().numpy()
        for r in over:
            ties[int(sub[r])] = idx2[r, : int(cnt[r])].astype(np.int64)


def _best_matrix_t(seg_codes: np.ndarray, peq: np.ndarray, m: int, dev) -> torch.Tensor:
    """(P, Rc) int8 best-distance matrix on ``dev``, clamped at 127.

    ``peq`` is (5, P) single-word or (W, 5, P) multi-word. The single-word
    table goes through match_best (the K5 kernel on a CUDA device, its plain
    version on the CPU); the patterns it pads are sliced back off. The
    multi-word table takes the plain multi-word sweep, pattern-chunked, on
    every device: no kernel exists for it."""
    P = peq.shape[-1]
    if peq.ndim == 2:
        ls = seg_codes.shape[1]
        seg_T = torch.from_numpy(prep_segs_T(seg_codes, ls=ls, br=1)).to(dev)
        peq_pm = torch.from_numpy(prep_peq_cols(peq)).to(dev)
        return match_best(seg_T, peq_pm, m)[:P]
    seg_T = torch.from_numpy(np.ascontiguousarray(seg_codes.T)).to(dev)
    cols = []
    for s, e in batch_iter(P, 4096):
        blk = torch.from_numpy(np.ascontiguousarray(peq[:, :, s:e])).to(dev)
        cols.append(match_best_mw_t(seg_T, blk, m).T)
    # clamp before the int8 cast (distances can reach m; mr < 127 in
    # practice, so the clamp cannot collide with a real target)
    return torch.cat(cols, dim=1).clamp(max=127).to(torch.int8).T
