"""``extract_lr_bc``'s answer: one TSV row per read.

Per read, the adapter a1 and its reverse complement a2 are aligned as
infixes (edlib's HW mode). The strand with the smaller distance wins; equal
distances leave the read without a strand. Forward locations are every
optimal end; reverse locations are, per optimal end e of a2, the start of
the longest optimal alignment ending at e (edlib's reverse prefix pass),
written start - len - 1. Locations of reads at distance 0..5 make one
histogram per strand, whose peaks become ranges [first, last). A read is
kept when all its locations fall in one range; its segment is
seq[s:e or None], forward s = max(0, min - 2), e = max + num_bp_after,
loc = s; reverse s = min - num_bp_after, e = min(0, max + 2), loc = e.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import seqs
from .edit import dp_columns


def _codes(text: str) -> np.ndarray:
    return np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                           np.frombuffer(text.encode(), np.uint8)).astype(np.int16)


def end_scores(pats: np.ndarray, reads: np.ndarray, lens: np.ndarray, device,
               block: int = 1 << 18):
    """(d, ends) per pattern: d (P, R) least distance; ends a list per
    pattern of (read, end) pairs at that distance."""
    P = pats.shape[0]
    R, W = reads.shape
    d = np.zeros((P, R), np.int64)
    pairs = [[] for _ in range(P)]
    tp = torch.from_numpy(pats).to(device)
    for s in range(0, R, block):
        tx = torch.from_numpy(reads[s:s + block]).to(device)
        ln = torch.from_numpy(lens[s:s + block]).to(device)
        Wb = int(ln.max())
        sc = torch.empty((tx.shape[0], P, Wb), dtype=torch.int16, device=device)
        for j, col in dp_columns(tp, tx[:, :Wb]):
            sc[:, :, j] = col
        live = torch.arange(Wb, device=device)[None, None, :] < ln[:, None, None]
        sc = torch.where(live, sc, torch.iinfo(torch.int16).max)
        dm = sc.min(dim=2).values
        d[:, s:s + block] = dm.T.cpu().numpy()
        for p in range(P):
            r, e = torch.nonzero(sc[:, p, :] == dm[:, p, None], as_tuple=True)
            pairs[p].append((r.cpu().numpy() + s, e.cpu().numpy()))
    return d, [(np.concatenate([a for a, _ in pr]), np.concatenate([b for _, b in pr]))
               for pr in pairs]


def longest_starts(a2: np.ndarray, reads: np.ndarray, rid: np.ndarray, end: np.ndarray,
                   device, block: int = 1 << 18) -> np.ndarray:
    """Per (read, end): the start of the longest optimal alignment of a2
    ending at end (a prefix alignment of reversed a2 to the reversed read
    from end back)."""
    m = a2.size
    W = 2 * m  # an optimal alignment spans at most m + d <= 2m - 1 bases
    starts = np.zeros(rid.size, np.int64)
    pat = torch.from_numpy(a2[::-1].copy()).to(device)[None, :]
    for s in range(0, rid.size, block):
        r, e = rid[s:s + block], end[s:s + block]
        cols = e[:, None] - np.arange(W)[None, :]
        txt = np.take_along_axis(reads[r], np.maximum(cols, 0), axis=1).astype(np.int16)
        n_ok = np.minimum(W, e + 1)
        tx = torch.from_numpy(txt).to(device)
        sc = torch.empty((r.size, W), dtype=torch.int16, device=device)
        for j, col in dp_columns(pat, tx, shw=True):
            sc[:, j] = col[:, 0]
        live = torch.arange(W, device=device)[None, :] < torch.from_numpy(n_ok).to(device)[:, None]
        sc = torch.where(live, sc, torch.iinfo(torch.int16).max)
        best = sc.min(dim=1, keepdim=True).values
        jj = torch.arange(W, device=device)[None, :].expand_as(sc)
        k = torch.where(sc == best, jj, -1).max(dim=1).values.cpu().numpy()
        starts[s:s + block] = e - k
    return starts


def peak_ranges(locs: np.ndarray) -> list[tuple[int, int]]:
    """Peaks of the location histogram: while the 40-bin neighbourhood of
    the top bin holds 1% of all locations, grow the peak over bins above
    0.1% (not onto the histogram's first bin), record it, and clear it and
    20 bins around it."""
    if locs.size == 0:
        return []
    lo = int(locs.min())
    F = np.bincount(locs - lo).astype(np.float64)
    T, n = F.sum(), F.size
    out = []
    while True:
        p = int(np.argmax(F))
        if F[max(0, p - 20):min(p + 20, n)].sum() < 0.01 * T:
            return out
        first = last = p
        while first - 1 > 0 and F[first - 1] > 0.001 * T:
            first -= 1
        while last + 1 < n and F[last + 1] > 0.001 * T:
            last += 1
        F[max(0, first - 20):min(last + 20, n)] = 0
        out.append((lo + first, lo + last))


def _range_ids(locs: np.ndarray, ranges) -> np.ndarray:
    ids = np.full(locs.shape, -1, np.int64)
    for i, (s, e) in enumerate(ranges):
        ids[(locs >= s) & (locs < e)] = i
    return ids


def expected_tsv(data: dict, adapter: str, num_bp_after: int, device,
                 band: int | None = None) -> bytes:
    """The stage's whole output (uncompressed). ``band`` (a control): reads
    whose least distance exceeds it get no strand."""
    reads, lens = data["reads"], data["lens"]
    R = lens.size
    a1 = _codes(adapter)
    a2 = (3 - a1[::-1]).astype(np.int16)
    d, ends = end_scores(np.stack([a1, a2]), reads, lens, device)
    d1, d2 = d
    strand = np.where(d1 < d2, 0, np.where(d2 < d1, 1, -1))
    dist = np.where(strand == 0, d1, np.where(strand == 1, d2, -1))
    if band is not None:
        out = np.minimum(d1, d2) > band
        strand[out], dist[out] = -1, -1

    fr, fe = ends[0]
    keep = strand[fr] == 0
    fr, floc = fr[keep], fe[keep]
    rr, re_ = ends[1]
    keep = strand[rr] == 1
    rr, re_ = rr[keep], re_[keep]
    rloc = longest_starts(a2, reads, rr, re_, device) - lens[rr] - 1
    rid = np.concatenate([fr, rr])
    loc = np.concatenate([floc, rloc])

    near = (dist[rid] >= 0) & (dist[rid] <= 5)
    is_f = strand[rid] == 0
    ids = np.where(is_f, _range_ids(loc, peak_ranges(loc[near & is_f])), -1)
    ids = np.where(~is_f, _range_ids(loc, peak_ranges(loc[near & ~is_f])), ids)

    big = np.iinfo(np.int64).max
    idmin = np.full(R, big)
    idmax = np.full(R, -big)
    lmin = np.full(R, big)
    lmax = np.full(R, -big)
    np.minimum.at(idmin, rid, ids)
    np.maximum.at(idmax, rid, ids)
    np.minimum.at(lmin, rid, loc)
    np.maximum.at(lmax, rid, loc)
    valid = (strand >= 0) & (idmin == idmax) & (idmin >= 0)

    fwd = strand == 0
    s = np.where(fwd, np.maximum(0, lmin - 2), lmin - num_bp_after)
    e = np.where(fwd, lmax + num_bp_after, np.minimum(0, lmax + 2))
    out_loc = np.where(fwd, s, e)
    # seq[s:e or None] with Python's slice rules
    sn = np.clip(np.where(s < 0, s + lens, s), 0, lens)
    ee = np.where(e == 0, lens, e)
    en = np.clip(np.where(ee < 0, ee + lens, ee), 0, lens)
    seg_len = np.where(valid, np.maximum(0, en - sn), 0)
    w = max(1, int(seg_len.max()) if R else 1)
    cols = np.minimum(np.where(valid, sn, 0)[:, None] + np.arange(w)[None, :], reads.shape[1] - 1)
    seg = np.take_along_axis(reads, cols, axis=1)

    d_txt = seqs.int_field(np.where(valid, dist, -1))
    l_txt = seqs.int_field(np.where(valid, out_loc, 0))
    na = seqs.const_field(R, b"NA")
    loc_mat = np.where(valid[:, None], np.pad(l_txt[0], ((0, 0), (0, max(0, 2 - l_txt[0].shape[1])))),
                       np.pad(na[0], ((0, 0), (0, max(0, l_txt[0].shape[1] - 2)))))
    loc_len = np.where(valid, l_txt[1], 2)
    names = (data["names"], np.full(R, data["names"].shape[1]))
    return seqs.join_rows([names, d_txt, (loc_mat, loc_len), seqs.text_field(seg, seg_len)])
