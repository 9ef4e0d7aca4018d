"""Host exact-match prefilter for the stage-3 matcher.

A copy of sctagger_tpu/ops/exact_prefilter.py (that package's ops/__init__
imports jax eagerly); tests/test_torch_prefilter.py holds the two equal.

A segment whose min infix edit distance over all patterns is ZERO has its
complete reference tie set determined by exact substring hits alone: dist 0
means the pattern occurs verbatim in the segment (SURVEY.md §3.4 — the trie
records a read at distance mr-error_left==0 exactly when a window equals the
barcode, scTagger.py:566-588), so

    min == 0  <=>  some length-bl window of the segment equals some pattern,
    tie set at 0 == the distinct patterns occurring as windows.

That is computable on the HOST with vectorized 2-bit-packed window lookups at
~10x the device's dense-DP match rate, so the production matcher resolves
dist-0 reads here and ships only the remainder to the device — on real ONT
data (and the flagship bench distribution) that is ~40% of reads. The device
path's semantics for surviving reads are unchanged; for resolved reads this
module reproduces the fused kernel's outputs exactly: min=0, tie count =
number of distinct dist-0 patterns, slots ascending by pattern id (the
reference's (bid, strand) sort order, scTagger.py:789).

Only used for bl <= 32 (2-bit keys fit one uint64); the multi-word path
(bl > 32) skips the prefilter.

The distance<=1 tier (NeighborhoodIndex) extends the same trick one edit up:
for every pattern, enumerate its single-edit neighborhood — all strings at
Levenshtein distance <= 1, which have lengths bl-1 (deletions), bl
(substitutions + the pattern itself), and bl+1 (insertions) — and build one
sorted key table per length. A segment window of length k equals a
neighborhood entry of pattern p  <=>  lev(p, window) <= 1, and conversely any
pattern at infix distance exactly 1 has a witness substring of length in
{bl-1, bl, bl+1} (each edit changes length by at most 1), so

    min <= 1            <=>  some window hits some neighborhood entry,
    tie set at min==1   ==   {p : neighborhood hit} \\ {p : exact hit},

which lets the host resolve the dist-1 slab (~28% of the flagship workload,
on top of the 44% dist-0 slab) with the exact tie sets the fused kernel
would produce (scTagger.py:566-588 pays nothing extra for near-exact reads
in its DFS; this is the host-side equivalent). Requires bl <= 31 so the
length-(bl+1) keys fit 64 bits.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..observability import count

# native probe threads: every host core (the probe runs while the device
# crunches the previous chunk; numpy phases release the GIL anyway)
_N_THREADS = os.cpu_count() or 2


@dataclasses.dataclass
class ExactHits:
    """CSR tie sets for reads with at least one exact (dist-0) hit.

    Read ``rids[i]`` has the sorted distinct pattern ids
    ``pids[offsets[i]:offsets[i+1]]``, all at edit distance 0.
    """

    rids: np.ndarray  # (M,) int64, ascending
    offsets: np.ndarray  # (M+1,) int64
    pids: np.ndarray  # (total,) int64, ascending within each read


def _pack_rows(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Every k-window of each row packed into one integer (2 bits/base).

    codes: (N, L) values 0..4 (4 = pad/invalid). Returns (keys (N, W) uint32
    for k <= 16 else uint64, bad (N, W) bool) with W = L-k+1; ``bad`` marks
    windows containing an invalid code. Callers mask by row length
    separately.

    Layout note: the rolling update walks COLUMNS with (N,)-shaped state —
    window j's key is window j-1's shifted left two bits — instead of
    materializing k strided (N, W) temporaries, which thrash the host's
    page-fault cliff (fresh multi-MB malloc pages can fault at ~500us/page;
    measured 4-6s vs ~0.2s at N=262144)."""
    assert k <= 32, k
    n, L = codes.shape
    W = L - k + 1
    wdt = np.uint32 if k <= 16 else np.uint64
    if W <= 0:
        return np.zeros((n, 0), wdt), np.zeros((n, 0), bool)
    nbits = 2 * k
    keys = np.zeros((n, W), dtype=wdt)
    bad = np.zeros((n, W), dtype=bool)
    key = np.zeros(n, dtype=wdt)
    tmp = np.zeros(n, dtype=wdt)
    last_bad = np.full(n, -1, dtype=np.int32)  # small: first-touch ok
    isbad = np.zeros(n, dtype=bool)
    for j in range(L):
        col = codes[:, j]
        np.left_shift(key, wdt(2), out=key)
        if nbits < key.dtype.itemsize * 8:  # drop bits older than the window
            key &= wdt((1 << nbits) - 1)
        np.bitwise_and(col.astype(wdt), wdt(3), out=tmp)
        np.bitwise_or(key, tmp, out=key)
        np.greater(col, 3, out=isbad)
        last_bad[isbad] = j
        if j >= k - 1:
            w = j - k + 1
            keys[:, w] = key
            np.greater_equal(last_bad, w, out=bad[:, w])
    return keys, bad


def exact_tie_probe(
    seg_codes: np.ndarray, lengths: np.ndarray, pat_codes: np.ndarray
) -> ExactHits:
    """All (read, pattern) exact-substring pairs, deduplicated across windows.

    seg_codes: (R, L) uint8 codes (values 0..4; pad only past each row's
    length). lengths: (R,) real lengths. pat_codes: (P, bl) codes 0..3 —
    duplicate pattern rows are allowed (e.g. a barcode equal to another's
    revcomp) and each duplicate id is reported, matching the dense kernel.
    """
    P, bl = pat_codes.shape
    pat_keys, pat_bad = _pack_rows(pat_codes, bl)  # (P, 1)
    assert not pat_bad.any(), "patterns must be fully encoded (codes 0..3)"
    pat_keys = pat_keys[:, 0]
    order = np.argsort(pat_keys, kind="stable")
    sorted_keys = pat_keys[order]
    sorted_pids = order.astype(np.int64)

    keys, bad = _pack_rows(seg_codes, bl)  # (R, W)
    R, W = keys.shape
    if W == 0 or P == 0:
        z = np.zeros(0, np.int64)
        return ExactHits(z, np.zeros(1, np.int64), z)
    valid = (~bad) & (np.arange(W)[None, :] + bl <= lengths[:, None])

    flat = keys[valid]
    wread = np.broadcast_to(np.arange(R, dtype=np.int64)[:, None], (R, W))[
        valid
    ]
    lo = np.searchsorted(sorted_keys, flat, side="left")
    # right bounds only for actual hits (misses dominate): second search runs
    # on the ~5% hit subset instead of every window
    ishit = sorted_keys[np.minimum(lo, sorted_keys.size - 1)] == flat
    ii = np.flatnonzero(ishit)
    if ii.size == 0:
        z = np.zeros(0, np.int64)
        return ExactHits(z, np.zeros(1, np.int64), z)
    hi = np.searchsorted(sorted_keys, flat[ii], side="right")
    counts = hi - lo[ii]
    total = int(counts.sum())
    # expand [lo, hi) ranges: table_pos = repeat(lo - exclusive_cumsum, counts)
    # + arange(total)
    excl = np.cumsum(counts) - counts
    table_pos = np.repeat(lo[ii] - excl, counts) + np.arange(total)
    pids = sorted_pids[table_pos]
    reads = np.repeat(wread[ii], counts)

    # dedup (read, pid) pairs — the same pattern can hit several windows
    srt = np.lexsort((pids, reads))
    r, p = reads[srt], pids[srt]
    keep = np.ones(r.size, bool)
    keep[1:] = (r[1:] != r[:-1]) | (p[1:] != p[:-1])
    r, p = r[keep], p[keep]
    rids, tie_counts = np.unique(r, return_counts=True)
    offsets = np.zeros(rids.size + 1, np.int64)
    np.cumsum(tie_counts, out=offsets[1:])
    return ExactHits(rids, offsets, p)


@dataclasses.dataclass
class D1Hits:
    """CSR tie sets for reads whose min infix distance is 0 or 1.

    Read ``rids[i]`` achieved min distance ``dists[i]`` (0 or 1) with the
    sorted distinct pattern ids ``pids[offsets[i]:offsets[i+1]]`` at exactly
    that distance — the fused kernel's (min, tie set) for these reads.
    """

    rids: np.ndarray  # (M,) int64, ascending
    offsets: np.ndarray  # (M+1,) int64
    pids: np.ndarray  # (total,) int64, ascending within each read
    dists: np.ndarray  # (M,) uint8, 0 or 1


def _empty_d1() -> D1Hits:
    z = np.zeros(0, np.int64)
    return D1Hits(z, np.zeros(1, np.int64), z, np.zeros(0, np.uint8))


def _pattern_keys(pat_codes: np.ndarray) -> np.ndarray:
    """(P,) uint64 2-bit-packed pattern keys (char 0 in the top bits)."""
    P, bl = pat_codes.shape
    assert (pat_codes <= 3).all(), "patterns must be fully encoded (codes 0..3)"
    key = np.zeros(P, np.uint64)
    for j in range(bl):
        key = (key << np.uint64(2)) | pat_codes[:, j].astype(np.uint64)
    return key


def _dedup_minkeep(keys, pids, dists):
    """Sort by key (pid, then dist ascending within), keep the min-dist entry
    of every (key, pid) pair. Returns key-sorted arrays."""
    srt = np.lexsort((dists, pids, keys))
    k, p, d = keys[srt], pids[srt], dists[srt]
    keep = np.ones(k.size, bool)
    keep[1:] = (k[1:] != k[:-1]) | (p[1:] != p[:-1])
    return k[keep], p[keep], d[keep]


_lib_box: list = []


def _native_lib():
    """The host C++ library's bucketed range search (native/range_search.cpp),
    ~20x numpy searchsorted on these table sizes; None if unavailable."""
    if not _lib_box:
        try:
            from ..native.build import load

            _lib_box.append(load())
        except Exception:  # pragma: no cover - build toolchain missing
            _lib_box.append(None)
    return _lib_box[0]


class NeighborhoodIndex:
    """Sorted single-edit neighborhood tables, one per window length.

    ``tables[k] = (keys, pids, dists)``: every string at lev distance <= 1 of
    some pattern with length k, as a key-sorted array; ``dists`` is 0 for the
    pattern itself (k == bl only) and 1 otherwise (min kept on collisions).
    Correctness argument in the module docstring. Build cost is one-time per
    whitelist (~7.4M entries for 50K 16bp patterns) and the production
    matcher builds it on a worker thread behind the first device chunk.
    """

    def __init__(self, pat_codes: np.ndarray):
        P, bl = pat_codes.shape
        assert bl <= 31, bl  # bl+1 keys must fit 64 bits
        assert P > 0
        self.bl = bl
        key = _pattern_keys(pat_codes)
        pid = np.arange(P, dtype=np.int32)
        two = np.uint64(2)

        def _shift(j: int) -> np.uint64:  # bit offset of char j's low bit
            return np.uint64(2 * (bl - 1 - j))

        # substitutions (+ the original pattern at dist 0), length bl
        ks_bl = [key]
        ds_bl = [np.zeros(P, np.uint8)]
        ps_bl = [pid]
        for j in range(bl):
            sh = _shift(j)
            base = key & ~(np.uint64(3) << sh)
            for c in range(4):
                ks_bl.append(base | (np.uint64(c) << sh))
                ps_bl.append(pid)
                ds_bl.append(np.ones(P, np.uint8))
        # deletions, length bl-1
        ks_d, ps_d = [], []
        for j in range(bl):
            lowbits = np.uint64(2 * (bl - 1 - j))
            high = key >> np.uint64(2 * (bl - j))
            low = key & ((np.uint64(1) << lowbits) - np.uint64(1))
            ks_d.append((high << lowbits) | low)
            ps_d.append(pid)
        # insertions, length bl+1
        ks_i, ps_i = [], []
        for j in range(bl + 1):
            lowbits = np.uint64(2 * (bl - j))
            high = key >> lowbits
            low = key & ((np.uint64(1) << lowbits) - np.uint64(1))
            for c in range(4):
                ks_i.append(
                    (high << (lowbits + two))
                    | (np.uint64(c) << lowbits)
                    | low
                )
                ps_i.append(pid)

        self.tables: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self.buckets: dict[int, tuple[np.ndarray, int]] = {}  # (off, shift)
        for k, kk, pp, dd in (
            (bl - 1, ks_d, ps_d, None),
            (bl, ks_bl, ps_bl, ds_bl),
            (bl + 1, ks_i, ps_i, None),
        ):
            if k <= 0:
                continue
            keys = np.concatenate(kk)
            pids = np.concatenate(pp)
            dists = (
                np.concatenate(dd)
                if dd is not None
                else np.ones(keys.size, np.uint8)
            )
            skeys, spids, sdists = _dedup_minkeep(keys, pids, dists)
            self.tables[k] = (skeys, spids, sdists)
            # top-bits bucket boundaries for the native search: narrow each
            # query from a ~5M-entry binary search to ~10 entries
            bucket_bits = min(18, 2 * k)
            shift = 2 * k - bucket_bits
            nb = 1 << bucket_bits
            off = np.zeros(nb + 1, np.int64)
            off[1:nb] = np.searchsorted(
                skeys, np.arange(1, nb, dtype=np.uint64) << np.uint64(shift)
            )
            off[nb] = skeys.size
            self.buckets[k] = (off, shift)

    def probe(self, seg_codes: np.ndarray, lengths: np.ndarray) -> D1Hits:
        """All reads with min infix distance <= 1, with exact tie sets.

        Same contract as exact_tie_probe but two distance tiers; pad codes
        (> 3) may appear only past each row's length OR inside it (windows
        containing them are skipped, consistent with the exact probe — the
        production encoder is LENIENT so in-length codes are always 0..3).
        """
        R, L = seg_codes.shape
        ks = sorted(self.tables)
        per_k = _pack_rows_multi(seg_codes, ks)
        reads_l: list[np.ndarray] = []
        pids_l: list[np.ndarray] = []
        dists_l: list[np.ndarray] = []
        lib = _native_lib()
        for k in ks:
            keys, bad = per_k[k]
            W = keys.shape[1]
            if W == 0:
                continue
            skeys, spids, sdists = self.tables[k]
            valid = (~bad) & (np.arange(W)[None, :] + k <= lengths[:, None])
            flat = keys[valid]
            if flat.size == 0:
                continue
            wread = np.broadcast_to(
                np.arange(R, dtype=np.int64)[:, None], (R, W)
            )[valid]
            if lib is not None:
                off, shift = self.buckets[k]
                lo = np.zeros(flat.size, np.int64)  # zeros: calloc-backed
                cnt = np.zeros(flat.size, np.int32)
                lib.sctag_range_search_u64(
                    skeys.ctypes.data, skeys.size, off.ctypes.data, shift,
                    flat.ctypes.data, flat.size, _N_THREADS,
                    lo.ctypes.data, cnt.ctypes.data,
                )
                ii = np.flatnonzero(cnt > 0)
                if ii.size == 0:
                    continue
                counts = cnt[ii].astype(np.int64)
                lo_hit = lo[ii]
            else:  # numpy fallback (no host toolchain)
                lo = np.searchsorted(skeys, flat, side="left")
                ishit = skeys[np.minimum(lo, skeys.size - 1)] == flat
                ii = np.flatnonzero(ishit)
                if ii.size == 0:
                    continue
                hi = np.searchsorted(skeys, flat[ii], side="right")
                counts = hi - lo[ii]
                lo_hit = lo[ii]
            total = int(counts.sum())
            excl = np.cumsum(counts) - counts
            table_pos = np.repeat(lo_hit - excl, counts) + np.arange(total)
            reads_l.append(np.repeat(wread[ii], counts))
            pids_l.append(spids[table_pos].astype(np.int64))
            # 2 * dist, + 1 for a window of length bl +- 1 (an indel)
            dists_l.append(sdists[table_pos] * np.uint8(2) + np.uint8(k != self.bl))
        if not reads_l:
            return _empty_d1()
        reads = np.concatenate(reads_l)
        pids = np.concatenate(pids_l)
        dists = np.concatenate(dists_l)

        # dedup (read, pid) keeping the min dist, order (read asc, pid asc);
        # at equal dist a length-bl window's hit is kept before an indel's
        srt = np.lexsort((dists, pids, reads))
        r, p, d = reads[srt], pids[srt], dists[srt]
        keep = np.ones(r.size, bool)
        keep[1:] = (r[1:] != r[:-1]) | (p[1:] != p[:-1])
        r, p, d = r[keep], p[keep], d[keep]

        rids, counts = np.unique(r, return_counts=True)
        starts = np.zeros(rids.size, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rmin = np.minimum.reduceat(d, starts) >> 1
        at_min = (d >> 1) == np.repeat(rmin, counts)
        # reads at dist 1 with a tie that only a bl +- 1 window reaches
        count("prefilter_d1_indel",
              np.count_nonzero(np.logical_or.reduceat(at_min & (d == 3), starts)))
        p = p[at_min]
        tie_counts = np.add.reduceat(at_min, starts)
        offsets = np.zeros(rids.size + 1, np.int64)
        np.cumsum(tie_counts, out=offsets[1:])
        return D1Hits(rids, offsets, p, rmin)


def _pack_rows_multi(
    codes: np.ndarray, ks: list[int]
) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """One column walk emitting the window keys for several lengths at once.

    Same per-k contract as _pack_rows (keys (N, L-k+1), bad (N, L-k+1)) but
    all keys uint64 (the native range search's query dtype); the running key
    is maintained once at max(ks) width and masked down per k, so probing
    three neighborhood lengths costs one pass instead of three.
    """
    kmax = max(ks)
    assert kmax <= 32, kmax  # 2*kmax bits fit uint64 (kmax == 32 exactly)
    n, L = codes.shape
    out = {}
    for k in ks:
        W = max(L - k + 1, 0)
        out[k] = (np.zeros((n, W), np.uint64), np.zeros((n, W), bool))
    if L == 0:
        return out
    masks = {k: np.uint64((1 << (2 * k)) - 1) for k in ks}
    run_mask = np.uint64((1 << (2 * kmax)) - 1)
    key = np.zeros(n, np.uint64)
    tmp = np.zeros(n, np.uint64)
    last_bad = np.full(n, -1, np.int32)  # small: first-touch ok
    isbad = np.zeros(n, bool)
    for j in range(L):
        col = codes[:, j]
        np.left_shift(key, np.uint64(2), out=key)
        key &= run_mask
        np.bitwise_and(col.astype(np.uint64), np.uint64(3), out=tmp)
        np.bitwise_or(key, tmp, out=key)
        np.greater(col, 3, out=isbad)
        last_bad[isbad] = j
        for k in ks:
            if j >= k - 1:
                w = j - k + 1
                keys_k, bad_k = out[k]
                keys_k[:, w] = (key & masks[k]).astype(keys_k.dtype)
                np.greater_equal(last_bad, w, out=bad_k[:, w])
    return out
