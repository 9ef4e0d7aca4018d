"""Stage-1 adapter localization (torch port of sctagger_tpu/models/adapter.py).

Replaces edlib's HW alignment of the SR adapter and its reverse complement
against every long read (reference get_alns, scTagger.py:176-196). Per read
it reproduces edlib's observable surface exactly:

  forward strand : d1 and ALL optimal end positions (edlib `locations` x[1]);
  reverse strand : d2 and, per optimal end, the MINIMAL optimal start
                   (edlib computes starts by a reverse SHW pass and keeps its
                   furthest position; reported as x[0]-len(seq)-1,
                   scTagger.py:189);
  tie d1 == d2   : read invalid (strand 'NA', d=-1, scTagger.py:182-183).

One code path serves every device:
  1. the host prefilter (native d<=1 scan, d<=2 opt-in; streaming path only)
     decides the reads whose adapter distance it can prove;
  2. the rest are sorted by length and cut into chunks for the adapter-scan
     kernel K6 (ops/adapter_cuda.py: the CUDA kernel on the card, its plain
     version on the CPU);
  3. reads the kernel cannot decide (non-ACGT chars, more than SLOTS_K
     optimal ends) and every read of an adapter longer than 32 bp take the
     exact mask path (_hw_block);
  4. '-' reads recover their alignment starts by a reverse SHW pass over
     fixed 2m-wide windows (k <= m+d-1 positions can be optimal, so the
     window is lossless).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sctagger_tpu.core.packing import (
    STRICT_TABLE,
    encode_rows,
    encode_seqs,
    encode_str,
    rev_compl,
    seq_lengths,
)
from sctagger_tpu.utils import batch_iter, full_fast, prof_timer, round_up
from sctagger_tpu.utils.misc import PROF, _PROF_LOCK

from ..ops.adapter_cuda import (
    SLOTS_K,
    adapter_scan,
    pack_chunk,
    prep_peq,
    row_bytes,
    unpack_scan_out,
)
from ..ops.myers import (
    MAX_PATTERN_LEN,
    build_peq_multi,
    build_peq_multi_mw,
    build_peq_single,
    build_peq_single_mw,
    scores_scan,
    scores_scan_mw,
)
from ..runtime import resolve_device

CHUNK_READS = 131072  # reads per kernel launch, at most
ENC_DEPTH = 4  # chunks packed ahead of their launch
MASK_BATCH = 256  # reads per mask-path block
REV_BATCH = 65536  # windows per reverse-recovery block


@dataclasses.dataclass
class AdapterScanResult:
    """Per-read alignment info in reference get_alns terms."""

    strands: np.ndarray  # (N,) int8: 0='+', 1='-', -1='NA' (tie)
    dists: np.ndarray  # (N,) int32: chosen-strand distance, -1 for NA
    flat_locs: np.ndarray  # (M,) int64 locs concatenated read-major
    loc_counts: np.ndarray  # (N,) int64


def _count(key: str, n) -> None:
    """Add a COUNT (not seconds) to PROF, next to the phase timers."""
    with _PROF_LOCK:
        PROF[key] = PROF.get(key, 0.0) + float(n)


class _Acc:
    """What the paths produce, keyed by read id: strand and distance, flat
    (rid, loc) pieces, reverse start-recovery tasks (rid, end), and the
    reads that need the exact mask path."""

    def __init__(self, n: int):
        self.strands = full_fast(n, -1, np.int8)
        self.dists = full_fast(n, -1, np.int32)
        self.loc_rids: list[np.ndarray] = []
        self.loc_vals: list[np.ndarray] = []
        self.rev_rids: list[np.ndarray] = []
        self.rev_ends: list[np.ndarray] = []
        self.mask_rids: list[np.ndarray] = []

    def grow(self, n: int) -> None:
        if self.strands.size >= n:
            return
        cap = max(n, 2 * self.strands.size)
        for name, dtype in (("strands", np.int8), ("dists", np.int32)):
            old = getattr(self, name)
            new = full_fast(cap, -1, dtype)
            new[: old.size] = old
            setattr(self, name, new)


def _hw_block(text_T, peq2, lengths, m: int):
    """(L, B) codes + (5, 2) or (W, 5, 2) Peq -> per-read dists (B, 2) and
    argmin masks (L, B, 2) over valid positions only."""
    scan = scores_scan if peq2.dim() == 2 else scores_scan_mw
    scores = scan(text_T, peq2, m, shw=False)  # (L, B, 2)
    L = text_T.shape[0]
    pos = torch.arange(L, device=scores.device)[:, None]
    pos_valid = (pos < lengths[None, :])[:, :, None]
    masked = torch.where(pos_valid, scores, 1 << 20)
    d = masked.amin(dim=0).clamp(max=m)  # (B, 2); empty reads clamp to m
    return d, masked == d[None]


def _shw_last_block(win_T, peq_rev, wlens, targets, m: int):
    """Reverse-SHW start recovery: win_T (W, T) reversed window codes.

    Returns k_last (T,): the furthest window position whose SHW score equals
    the task's target distance (edlib's positionsSHW[last])."""
    scan = scores_scan if peq_rev.dim() == 1 else scores_scan_mw
    scores = scan(win_T, peq_rev, m, shw=True)  # (W, T)
    pos = torch.arange(win_T.shape[0], device=scores.device)[:, None]
    hit = (scores == targets[None, :]) & (pos < wlens[None, :])
    return torch.where(hit, pos, -1).amax(dim=0)


def _to(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def scan_adapters(
    seqs, adapter: str, progress: bool = False, device=None
) -> AdapterScanResult:
    """One-shot stage-1 scan over all reads (a list of str or a SeqBuffer)
    on ``device`` (runtime.resolve_device)."""
    dev = resolve_device(device)
    m = len(adapter)
    a2 = rev_compl(adapter)
    pat_stack = np.stack(
        [encode_str(adapter, STRICT_TABLE), encode_str(a2, STRICT_TABLE)]
    )
    n = len(seqs)
    lengths = seq_lengths(seqs)
    acc = _Acc(n)
    if m > MAX_PATTERN_LEN:  # multi-word: no kernel, exact mask path
        peq2 = build_peq_multi_mw(pat_stack)
        acc.mask_rids.append(np.arange(n, dtype=np.int64))
    else:
        peq2 = build_peq_multi(pat_stack)
        with _KernelPath(seqs, peq2, m, dev, acc, progress) as kp:
            kp.submit(np.arange(n, dtype=np.int64), lengths)
    return _finalize_scan(seqs, lengths, peq2, m, a2, acc, dev, progress)


class _KernelPath:
    """Reads through K6 in chunks of length-sorted reads: a worker thread
    packs the next chunks while this thread launches one and collects its
    rows. Use as a context manager; leaving it normally drains the queue."""

    def __init__(self, seqs, peq2, m: int, dev, acc: _Acc, progress: bool):
        self.seqs = seqs
        self.peq = prep_peq(peq2)
        self.m = m
        self.dev = dev
        self.acc = acc
        self.progress = progress
        if dev.type == "cuda":  # one chunk's text may take 1/8 of free memory
            self.budget = torch.cuda.mem_get_info(dev)[0] // 8
        else:
            self.budget = 1 << 28
        self.pool = ThreadPoolExecutor(1)
        self.queue: deque = deque()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                self._pump(block=True)
        finally:
            self.pool.shutdown(wait=exc_type is None, cancel_futures=True)
        return False

    def _chunk_len(self, lens_sorted: np.ndarray) -> int:
        """Reads of the next chunk: at most CHUNK_READS, and their padded
        rows within the byte budget (rows grow along the sorted lengths)."""
        rb = row_bytes(lens_sorted[:CHUNK_READS])
        fits = np.arange(1, rb.size + 1) * rb <= self.budget
        return max(1, int(fits.sum()))

    def submit(self, idx: np.ndarray, lens: np.ndarray) -> None:
        """Queue reads ``idx`` (global ids) with lengths ``lens``."""
        order = np.argsort(lens, kind="stable")
        idx, lens = idx[order], np.asarray(lens)[order]
        s = 0
        while s < idx.size:
            e = s + self._chunk_len(lens[s:])
            sub = idx[s:e]
            fut = self.pool.submit(self._pack, sub, int(lens[e - 1]))
            self.queue.append((fut, sub))
            s = e
            self._pump(block=False)

    def _pack(self, sub: np.ndarray, lmax: int):
        with prof_timer("scan.encode"):
            return pack_chunk(self.seqs, sub, lmax)

    def _pump(self, block: bool) -> None:
        while self.queue and (
            block or self.queue[0][0].done() or len(self.queue) >= ENC_DEPTH
        ):
            fut, sub = self.queue.popleft()
            text, lens, junk = fut.result()
            if self.progress:
                print(
                    f"[scan] kernel chunk: {sub.size} reads <= {text.shape[1] * 4}"
                    " chars", file=sys.stderr,
                )
            with prof_timer("scan.kernel"):  # upload, launch and wait
                out = adapter_scan(
                    _to(text, self.dev), _to(lens, self.dev), self.peq, self.m
                ).cpu().numpy()
            with prof_timer("scan.collect"):
                _kernel_collect(out, sub, self.acc, junk)
            _count("scan.kernel_reads", sub.size)
            _count("scan.kernel_chunks", 1)


def _finalize_scan(
    seqs, lengths, peq2, m, a2, acc: _Acc, dev, progress
) -> AdapterScanResult:
    """Shared scan tail (one-shot AND streaming paths): exact mask fallback,
    reverse-SHW start recovery, and flat (rid, loc) assembly."""
    n = len(seqs)
    ov = np.unique(np.concatenate([np.empty(0, np.int64), *acc.mask_rids]))
    if ov.size:
        ov = ov[np.argsort(lengths[ov], kind="stable")]  # similar-length blocks
        if progress:
            print(f"[scan] mask fallback for {ov.size} reads", file=sys.stderr)
        _count("scan.mask_reads", ov.size)
        with prof_timer("scan.mask_fallback"):
            peq_t = _to(peq2, dev)
            for s, e in batch_iter(ov.size, MASK_BATCH):
                sub = ov[s:e]
                L = round_up(max(int(lengths[sub].max()), 1), 32)
                codes, _ = encode_rows(seqs, sub, pad_to=L)
                _mask_chunk(codes, lengths[sub], peq_t, m, sub, acc)

    with prof_timer("scan.rev_recovery"):
        _recover_rev_starts(seqs, lengths, a2, m, acc, dev)

    if acc.loc_rids:
        rid_all = np.concatenate(acc.loc_rids)
        val_all = np.concatenate(acc.loc_vals)
        # stable: preserves each path's ascending within-read loc order
        order = np.argsort(rid_all, kind="stable")
        flat = np.ascontiguousarray(val_all[order])
        loc_counts = np.bincount(rid_all, minlength=n).astype(np.int64)
    else:
        flat = np.empty(0, dtype=np.int64)
        loc_counts = np.zeros(n, dtype=np.int64)
    return AdapterScanResult(acc.strands[:n], acc.dists[:n], flat, loc_counts)


def scan_adapters_stream(batches, adapter: str, progress: bool = False, device=None):
    """Streaming stage-1 scan: overlap FASTQ ingest with device compute.

    ``batches`` yields ``(names, SeqBuffer)`` in global read order (normally
    ``io.fastq.read_fastqs_stream`` driven from a producer thread), with an
    optional third element: the prefilter's raw scan of that batch (or a
    future of it) from ``make_d0_scanner``. Returns
    ``(rnames, chain, AdapterScanResult)`` where ``chain`` is the
    ChainSeqBuffer holding every batch (the stage writer needs the read text
    for segments).

    Reads the prefilter leaves open collect until CHUNK_READS of them wait;
    they then go to the kernel path, sorted by length. Multi-word adapters
    accumulate the chain and delegate to :func:`scan_adapters`.
    """
    from sctagger_tpu.io.fastq import ChainSeqBuffer

    dev = resolve_device(device)
    m = len(adapter)
    rnames: list[str] = []
    chain = ChainSeqBuffer()
    if m > MAX_PATTERN_LEN:
        for item in batches:
            rnames.extend(item[0])
            chain.append(item[1])
        return rnames, chain, scan_adapters(
            chain, adapter, progress=progress, device=dev
        )

    a2 = rev_compl(adapter)
    pat_stack = np.stack(
        [encode_str(adapter, STRICT_TABLE), encode_str(a2, STRICT_TABLE)]
    )
    peq2 = build_peq_multi(pat_stack)
    # host prefilter (native/adapter_d1.cpp): a read whose adapter distance
    # is provably 0 or 1 on exactly one strand is decided host-side (equal
    # minima on both strands => NA) and never reaches the kernel.
    # SCTAG_ADAPTER_D0=0 disables it.
    d0_scan = None
    if os.environ.get("SCTAG_ADAPTER_D0", "1") == "1":
        d0_scan = _make_d0_scanner(pat_stack, m)

    acc = _Acc(1024)
    pend_idx: list[np.ndarray] = []
    pend_lens: list[np.ndarray] = []
    pend_n = 0
    with _KernelPath(chain, peq2, m, dev, acc, progress) as kp:
        for item in batches:
            names, sb = item[0], item[1]
            raw = item[2] if len(item) > 2 else None
            if hasattr(raw, "result"):
                raw = raw.result()  # probe future (producer pipeline)
            rnames.extend(names)
            off = len(chain)
            chain.append(sb)
            if len(sb) == 0:
                continue
            acc.grow(len(chain))
            lens_b = np.asarray(sb.lengths)
            keep = None
            if d0_scan is not None:
                with prof_timer("scan.d0probe"):
                    keep = d0_scan.apply(
                        sb,
                        raw if raw is not None else d0_scan.raw(sb),
                        off, acc.strands, acc.dists, acc.loc_rids, acc.loc_vals,
                    )
                if keep is not None and progress:
                    print(
                        f"[scan] host prefilter: {int(len(sb) - keep.sum())}/"
                        f"{len(sb)} reads resolved", file=sys.stderr,
                    )
            sel = np.flatnonzero(keep) if keep is not None else np.arange(len(sb))
            pend_idx.append(off + sel.astype(np.int64))
            pend_lens.append(lens_b[sel])
            pend_n += sel.size
            if pend_n >= CHUNK_READS:
                kp.submit(np.concatenate(pend_idx), np.concatenate(pend_lens))
                pend_idx, pend_lens, pend_n = [], [], 0
        if pend_n:
            kp.submit(np.concatenate(pend_idx), np.concatenate(pend_lens))

    lengths = np.asarray(chain.lengths, np.int64)
    result = _finalize_scan(chain, lengths, peq2, m, a2, acc, dev, progress)
    return rnames, chain, result


def _mask_chunk(codes, sub_lens, peq2, m, sub, acc: _Acc):
    """Exact mask path: full argmin-end sets via (L, B) masks on the device
    of the Peq tensor ``peq2``."""
    dev = peq2.device
    d, mask = _hw_block(
        _to(codes.T, dev), peq2, _to(sub_lens.astype(np.int64), dev), m
    )
    d = d.cpu().numpy()
    mask = mask.cpu().numpy()
    d1, d2 = d[:, 0], d[:, 1]
    fwd = d1 < d2
    rev = d2 < d1
    acc.strands[sub[fwd]] = 0
    acc.strands[sub[rev]] = 1
    acc.dists[sub[fwd]] = d1[fwd]
    acc.dists[sub[rev]] = d2[rev]
    for bi in np.flatnonzero(fwd):
        ends = np.flatnonzero(mask[:, bi, 0]).astype(np.int64)
        acc.loc_rids.append(np.full(ends.size, sub[bi], dtype=np.int64))
        acc.loc_vals.append(ends)
    for bi in np.flatnonzero(rev):
        ends = np.flatnonzero(mask[:, bi, 1]).astype(np.int64)
        acc.rev_rids.append(np.full(ends.size, sub[bi], dtype=np.int64))
        acc.rev_ends.append(ends)


def _kernel_collect(out_np, sub, acc: _Acc, junk=None):
    """Vectorized unpack of one chunk's (12, B) kernel rows.

    ``junk`` marks rows with in-sequence non-ACGT chars: the packed kernel's
    output is unspecified for those, so they join the exact mask fallback,
    as do reads with more than SLOTS_K optimal ends on the chosen strand."""
    fwd_o, rc_o = unpack_scan_out(out_np, sub.size)
    d1, d2 = fwd_o["d"], rc_o["d"]
    fwd = d1 < d2
    rev = d2 < d1
    if junk is not None and junk.any():
        fwd &= ~junk
        rev &= ~junk
        acc.mask_rids.append(sub[junk])
    acc.strands[sub[fwd]] = 0
    acc.strands[sub[rev]] = 1
    acc.dists[sub[fwd]] = d1[fwd]
    acc.dists[sub[rev]] = d2[rev]

    karange = np.arange(SLOTS_K)[None, :]
    # forward: flat (rid, loc) arrays, read-major (slots ascend per read)
    ok = fwd & (fwd_o["cnt"] <= SLOTS_K)
    fi = np.flatnonzero(ok)
    if fi.size:
        cnts = fwd_o["cnt"][fi]
        flat = fwd_o["slots"][fi][karange < cnts[:, None]].astype(np.int64)
        acc.loc_rids.append(np.repeat(sub[fi], cnts))
        acc.loc_vals.append(flat)
    acc.mask_rids.append(sub[fwd & (fwd_o["cnt"] > SLOTS_K)])

    # reverse: flat (rid, end) task arrays, read-major
    ok = rev & (rc_o["cnt"] <= SLOTS_K)
    ri = np.flatnonzero(ok)
    if ri.size:
        cnts = rc_o["cnt"][ri]
        flat = rc_o["slots"][ri][karange < cnts[:, None]].astype(np.int64)
        acc.rev_rids.append(np.repeat(sub[ri], cnts))
        acc.rev_ends.append(flat)
    acc.mask_rids.append(sub[rev & (rc_o["cnt"] > SLOTS_K)])


def _recover_rev_starts(seqs, lengths, a2, m, acc: _Acc, dev):
    """Batch reverse-SHW over 2m-wide windows; fills locs for '-' reads."""
    if not acc.rev_rids:
        return
    rids = np.concatenate(acc.rev_rids)
    ends = np.concatenate(acc.rev_ends)
    W = 2 * m
    rev_codes = encode_str(a2, STRICT_TABLE)[::-1]
    peq_rev = _to(
        build_peq_single_mw(rev_codes)
        if m > MAX_PATTERN_LEN
        else build_peq_single(rev_codes),
        dev,
    )
    starts = np.zeros(rids.size, dtype=np.int64)
    # small slices only: SeqBuffer.substr avoids building full read strings
    substr = getattr(seqs, "substr", None) or (lambda r, a, b: seqs[r][a:b])
    for s, e in batch_iter(rids.size, REV_BATCH):
        rr, ee = rids[s:e], ends[s:e]
        wins = [
            substr(int(r), max(0, int(en) - W + 1), int(en) + 1)[::-1]
            for r, en in zip(rr, ee)
        ]
        codes, wl = encode_seqs(wins, pad_to=W)
        k_last = _shw_last_block(
            _to(codes.T, dev), peq_rev, _to(wl.astype(np.int64), dev),
            _to(acc.dists[rr], dev), m,
        )
        starts[s:e] = ee - k_last.cpu().numpy()
    # tasks are read-major with ends ascending per read: append flat
    acc.loc_rids.append(rids)
    acc.loc_vals.append(starts - lengths[rids].astype(np.int64) - 1)


# ---------------------------------------------------------------------------
# Host prefilter scanners (copied from sctagger_tpu/models/adapter.py; they
# call the reused native library). Counters: each tier counts only the reads
# it decided (scan.d0/d1/d2_resolved_reads), and the reads the native d1/d2
# scan gives up on (candidate overflow, flags != 0) count as
# scan.prefilter_deferred_reads.
# ---------------------------------------------------------------------------


class _D0Scanner:
    """Host exact-adapter resolver, split so the RAW scan (the byte pass)
    can run on the FASTQ-parse producer thread while the bytes are hot —
    the apply half (tiny numpy on hit subsets) stays on the consumer.

    ``raw(sb)`` scans one SeqBuffer batch -> (fwd_cnt, rc_cnt, ends) or
    None (no flat-buffer view). ``apply(sb, raw, off, ...)`` resolves every
    read with an exact hit (writing strands/dists/locs exactly as the
    kernel collect path would: fwd locs = exact ends ascending; rev locs =
    (end - m + 1) - len - 1, the dist-0 SHW start being exact; both-strand
    hits = the d1 == d2 tie => left NA) and returns the keep-mask of
    still-unresolved reads. Calling the scanner does both."""

    K = 8  # per-strand end slots; cnt > K defers to the device/mask path

    def __init__(self, lib, pat_stack: np.ndarray, m: int):
        from ..ops.exact_prefilter import _pattern_keys

        self.lib = lib
        keys = _pattern_keys(pat_stack)
        self.key_fwd, self.key_rc = int(keys[0]), int(keys[1])
        self.m = m
        self.table = np.ascontiguousarray(STRICT_TABLE)
        self.nthreads = os.cpu_count() or 2

    def raw(self, sb):
        buf = getattr(sb, "buf", None)
        offs = getattr(sb, "offs", None)
        if buf is None or offs is None:
            return None
        n = len(sb)
        offs = np.ascontiguousarray(offs, np.int64)
        fc = np.zeros(n, np.int32)
        rcnt = np.zeros(n, np.int32)
        ends = np.zeros((n, 2 * self.K), np.int64)
        self.lib.sctag_adapter_d0(
            buf.ctypes.data, offs.ctypes.data, n, self.table.ctypes.data,
            self.key_fwd, self.key_rc, self.m, self.K, self.nthreads,
            fc.ctypes.data, rcnt.ctypes.data, ends.ctypes.data,
        )
        return fc, rcnt, ends, offs

    def apply(self, sb, raw, off, strands, dists, loc_rids, loc_vals):
        if raw is None:
            return None
        fc, rcnt, ends, offs = raw
        K, m = self.K, self.m
        kar = np.arange(K)[None, :]
        both = (fc > 0) & (rcnt > 0)  # d1 == d2 == 0 tie: stays NA
        fwd_ok = (fc > 0) & (rcnt == 0) & (fc <= K)
        rev_ok = (rcnt > 0) & (fc == 0) & (rcnt <= K)
        fi = np.flatnonzero(fwd_ok)
        if fi.size:
            g = off + fi
            strands[g] = 0
            dists[g] = 0
            cnts = fc[fi]
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(ends[fi, :K][kar < cnts[:, None]])
        ri = np.flatnonzero(rev_ok)
        if ri.size:
            g = off + ri
            strands[g] = 1
            dists[g] = 0
            cnts = rcnt[ri]
            lens_r = (offs[ri + 1] - offs[ri]).astype(np.int64)
            e = ends[ri, K:][kar < cnts[:, None]]
            starts = e - (m - 1)
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
        resolved = both | fwd_ok | rev_ok
        _count("scan.d0_resolved_reads", resolved.sum())
        return ~resolved

    def __call__(self, sb, off, strands, dists, loc_rids, loc_vals):
        return self.apply(
            sb, self.raw(sb), off, strands, dists, loc_rids, loc_vals
        )


class _D1Scanner:
    """Host dist<=1 adapter resolver (native/adapter_d1.cpp).

    Same raw/apply split and accumulator contract as :class:`_D0Scanner`,
    with the extra tier: reads whose adapter min distance is 0 OR 1 on
    exactly one strand resolve host-side (d, strand, full edlib location
    set); 0/0, 1/1 cross-strand minima are the d1 == d2 tie => NA. The
    native scan emits EXACT per-strand end sets at distance 0 and 1
    (pigeonhole half-key screen + exact verify — see adapter_d1.cpp), so
    every decision below is certain:

      * f0>0 & r0>0            -> NA (0 == 0 tie)
      * f0>0 only              -> '+', d=0, locs = d0 ends
      * r0>0 only              -> '-', d=0, locs = (end-m+1) - len - 1
      * no d0; f1>0 & r1>0     -> NA (1 == 1 tie)
      * no d0; f1>0 only       -> '+', d=1, locs = d1 ends
      * no d0; r1>0 only       -> '-', d=1, locs = start - len - 1
        (starts come from the native scan: minimal optimal start per end)
      * otherwise (or slot/candidate overflow) -> undecided, device path
    """

    K = 8  # per-tier per-strand slots; cnt > K defers to the device path

    def __init__(self, lib, pat_stack: np.ndarray, m: int):
        self.lib = lib
        self.pat_fwd = np.ascontiguousarray(pat_stack[0], np.uint8)
        self.pat_rc = np.ascontiguousarray(pat_stack[1], np.uint8)
        self.m = m
        self.table = np.ascontiguousarray(STRICT_TABLE)
        self.nthreads = os.cpu_count() or 2

    def raw(self, sb):
        buf = getattr(sb, "buf", None)
        offs = getattr(sb, "offs", None)
        if buf is None or offs is None:
            return None
        n = len(sb)
        offs = np.ascontiguousarray(offs, np.int64)
        f0 = np.zeros(n, np.int32)
        r0 = np.zeros(n, np.int32)
        f1 = np.zeros(n, np.int32)
        r1 = np.zeros(n, np.int32)
        ends0 = np.zeros((n, 2 * self.K), np.int64)
        ends1 = np.zeros((n, 2 * self.K), np.int64)
        flags = np.zeros(n, np.uint8)
        self.lib.sctag_adapter_scan1(
            buf.ctypes.data, offs.ctypes.data, n, self.table.ctypes.data,
            self.pat_fwd.ctypes.data, self.pat_rc.ctypes.data, self.m,
            self.K, self.nthreads, f0.ctypes.data, r0.ctypes.data,
            f1.ctypes.data, r1.ctypes.data, ends0.ctypes.data,
            ends1.ctypes.data, flags.ctypes.data,
        )
        return f0, r0, f1, r1, ends0, ends1, flags, offs

    def apply(self, sb, raw, off, strands, dists, loc_rids, loc_vals):
        if raw is None:
            return None
        f0, r0, f1, r1, ends0, ends1, flags, offs = raw
        K, m = self.K, self.m
        kar = np.arange(K)[None, :]
        ok = flags == 0
        both0 = ok & (f0 > 0) & (r0 > 0)
        fwd0 = ok & (f0 > 0) & (r0 == 0) & (f0 <= K)
        rev0 = ok & (r0 > 0) & (f0 == 0) & (r0 <= K)
        no0 = ok & (f0 == 0) & (r0 == 0)
        both1 = no0 & (f1 > 0) & (r1 > 0)
        fwd1 = no0 & (f1 > 0) & (r1 == 0) & (f1 <= K)
        rev1 = no0 & (r1 > 0) & (f1 == 0) & (r1 <= K)

        def _emit_fwd(sel, ends, dvals, d):
            i = np.flatnonzero(sel)
            if not i.size:
                return
            g = off + i
            strands[g] = 0
            dists[g] = d
            cnts = dvals[i]
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(ends[i, :K][kar < cnts[:, None]])

        _emit_fwd(fwd0, ends0, f0, 0)
        _emit_fwd(fwd1, ends1, f1, 1)
        ri = np.flatnonzero(rev0)
        if ri.size:
            g = off + ri
            strands[g] = 1
            dists[g] = 0
            cnts = r0[ri]
            lens_r = (offs[ri + 1] - offs[ri]).astype(np.int64)
            e = ends0[ri, K:][kar < cnts[:, None]]
            starts = e - (m - 1)
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
        ri = np.flatnonzero(rev1)
        if ri.size:
            g = off + ri
            strands[g] = 1
            dists[g] = 1
            cnts = r1[ri]
            lens_r = (offs[ri + 1] - offs[ri]).astype(np.int64)
            starts = ends1[ri, K:][kar < cnts[:, None]]  # starts directly
            loc_rids.append(np.repeat(g, cnts))
            loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
        res0 = both0 | fwd0 | rev0
        res1 = both1 | fwd1 | rev1
        _count("scan.d0_resolved_reads", res0.sum())
        _count("scan.d1_resolved_reads", res1.sum())
        _count("scan.prefilter_deferred_reads", (~ok).sum())
        return ~(res0 | res1)

    def __call__(self, sb, off, strands, dists, loc_rids, loc_vals):
        return self.apply(
            sb, self.raw(sb), off, strands, dists, loc_rids, loc_vals
        )


class _D2Scanner:
    """Host dist<=2 adapter resolver (native/adapter_d2.cpp).

    Same raw/apply contract as :class:`_D1Scanner` with a third tier: the
    native scan emits EXACT per-strand end sets at distance 0, 1 AND 2
    (3-part pigeonhole screen + banded verify), so the cascade extends one
    level — equal cross-strand minima at any tier are the d1 == d2 tie =>
    NA, a strictly smaller minimum resolves that strand with its full
    edlib location set, and only reads whose minima are >= 3 on both
    strands (or that overflow the slot/candidate budget) ship to the
    device."""

    K = 8

    def __init__(self, lib, pat_stack: np.ndarray, m: int):
        self.lib = lib
        self.pat_fwd = np.ascontiguousarray(pat_stack[0], np.uint8)
        self.pat_rc = np.ascontiguousarray(pat_stack[1], np.uint8)
        self.m = m
        self.table = np.ascontiguousarray(STRICT_TABLE)
        self.nthreads = os.cpu_count() or 2

    def raw(self, sb):
        buf = getattr(sb, "buf", None)
        offs = getattr(sb, "offs", None)
        if buf is None or offs is None:
            return None
        n = len(sb)
        offs = np.ascontiguousarray(offs, np.int64)
        cnts = [np.zeros(n, np.int32) for _ in range(6)]
        ends = [np.zeros((n, 2 * self.K), np.int64) for _ in range(3)]
        flags = np.zeros(n, np.uint8)
        self.lib.sctag_adapter_scan2(
            buf.ctypes.data, offs.ctypes.data, n, self.table.ctypes.data,
            self.pat_fwd.ctypes.data, self.pat_rc.ctypes.data, self.m,
            self.K, self.nthreads,
            *(c.ctypes.data for c in cnts),
            *(e.ctypes.data for e in ends),
            flags.ctypes.data,
        )
        return cnts, ends, flags, offs

    def apply(self, sb, raw, off, strands, dists, loc_rids, loc_vals):
        if raw is None:
            return None
        (f0, r0, f1, r1, f2, r2), ends, flags, offs = raw
        K, m = self.K, self.m
        kar = np.arange(K)[None, :]
        fs = [f0, f1, f2]
        rs = [r0, r1, r2]
        # per-strand minimum over the resolved tiers (3 = "unknown, >= 3")
        fmin = np.select([f0 > 0, f1 > 0, f2 > 0], [0, 1, 2], 3)
        rmin = np.select([r0 > 0, r1 > 0, r2 > 0], [0, 1, 2], 3)
        ok = flags == 0
        resolved = np.zeros(len(f0), bool)
        tie = ok & (fmin == rmin) & (fmin < 3)
        resolved |= tie  # NA: strands/dists stay -1
        lens_all = (offs[1:] - offs[:-1]).astype(np.int64)
        for d in range(3):
            fwd_w = ok & (fmin == d) & (rmin > d) & (fs[d] <= K)
            fi = np.flatnonzero(fwd_w)
            if fi.size:
                g = off + fi
                strands[g] = 0
                dists[g] = d
                cnts = fs[d][fi]
                loc_rids.append(np.repeat(g, cnts))
                loc_vals.append(ends[d][fi, :K][kar < cnts[:, None]])
                resolved[fi] = True
            rev_w = ok & (rmin == d) & (fmin > d) & (rs[d] <= K)
            ri = np.flatnonzero(rev_w)
            if ri.size:
                g = off + ri
                strands[g] = 1
                dists[g] = d
                cnts = rs[d][ri]
                lens_r = lens_all[ri]
                v = ends[d][ri, K:][kar < cnts[:, None]]
                starts = v - (m - 1) if d == 0 else v  # d>0 slots = starts
                loc_rids.append(np.repeat(g, cnts))
                loc_vals.append(starts - np.repeat(lens_r, cnts) - 1)
                resolved[ri] = True
        dmin = np.minimum(fmin, rmin)
        for d in range(3):
            _count(f"scan.d{d}_resolved_reads", (resolved & (dmin == d)).sum())
        _count("scan.prefilter_deferred_reads", (~ok).sum())
        return ~resolved

    def __call__(self, sb, off, strands, dists, loc_rids, loc_vals):
        return self.apply(
            sb, self.raw(sb), off, strands, dists, loc_rids, loc_vals
        )


def _make_d0_scanner(pat_stack: np.ndarray, m: int):
    """Host prefilter scanner, or None if the adapter is not pure uppercase
    ACGT (a junk char can never match exactly under the STRICT alphabet, so
    the kernel path must handle such adapters — the packed keys cannot
    represent them). Returns the d<=1 scanner by default
    (SCTAG_ADAPTER_D1=0 drops back to d0 only; the d1 screen needs m >= 10
    for a selective half-key); SCTAG_ADAPTER_D2=1 selects the d<=2 tier at
    m >= 15 (its 3-part screen needs >= 5-char parts)."""
    if (pat_stack > 3).any():
        return None
    from sctagger_tpu.native.build import load

    lib = load()
    if os.environ.get("SCTAG_ADAPTER_D1", "1") != "1":
        return _D0Scanner(lib, pat_stack, m)
    if m >= 15 and os.environ.get("SCTAG_ADAPTER_D2", "0") == "1":
        return _D2Scanner(lib, pat_stack, m)
    if m >= 10:
        return _D1Scanner(lib, pat_stack, m)
    return _D0Scanner(lib, pat_stack, m)


def make_d0_scanner(adapter: str):
    """Producer-side host-prefilter scanner for stages/extract_lr_bc (None when
    disabled by SCTAG_ADAPTER_D0=0, the adapter exceeds one packed word, or
    it is not pure ACGT) — the SAME gating scan_adapters_stream applies, so
    a producer-attached raw result is always consumed."""
    m = len(adapter)
    if m > 32 or os.environ.get("SCTAG_ADAPTER_D0", "1") != "1":
        return None
    pat_stack = np.stack([
        encode_str(adapter, STRICT_TABLE),
        encode_str(rev_compl(adapter), STRICT_TABLE),
    ])
    return _make_d0_scanner(pat_stack, m)
