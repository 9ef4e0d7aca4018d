"""``extract_sr_bc_from_lr``'s answer: the whitelist rows a run keeps, with
their counts.

Semantics: every whitelist barcode is a word with value +i, its reverse
complement a word with value -i, all forward words first, a later word
replacing an earlier equal one. A row whose location is ``NA`` is skipped;
of the others, a row counts when exactly one of its 16 bp windows is a
word, for barcode |value|. Barcodes are ranked by count, descending, ties
by the row of their first count; the first ``max_barcode_cnt`` are kept,
then chunks of ``step_size`` are taken while a chunk holds at least
``thresh`` of the kept counts, the first chunk below it included."""

from __future__ import annotations

import numpy as np
import torch


def revcomp_keys(keys: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(keys)
    for i in range(k):  # base i of the barcode becomes base k-1-i, complemented
        out |= (3 - ((keys >> (2 * (k - 1 - i))) & 3)) << (2 * i)
    return out


def word_table(whitelist: np.ndarray, k: int, forward_only: bool = False):
    """(sorted keys, values) of the word dictionary."""
    n = whitelist.size
    keys = whitelist if forward_only else np.concatenate([whitelist, revcomp_keys(whitelist, k)])
    vals = np.arange(n, dtype=np.int64)
    if not forward_only:
        vals = np.concatenate([vals, -vals])
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    last = np.ones(keys.size, bool)
    last[:-1] = keys[1:] != keys[:-1]  # the last of equal keys is the latest added
    return keys[last], vals[last]


def row_hits(seg: np.ndarray, seg_lens: np.ndarray, keys: np.ndarray,
             vals: np.ndarray, k: int, device, block: int = 1 << 18):
    """(count of word windows, value of the hit when count == 1) per row."""
    tk = torch.from_numpy(keys).to(device)
    tv = torch.from_numpy(vals).to(device)
    n, w = seg.shape
    cnt = np.zeros(n, np.int64)
    val = np.zeros(n, np.int64)
    for s in range(0, n, block):
        c = torch.from_numpy(seg[s:s + block].astype(np.int64)).to(device)
        ln = torch.from_numpy(seg_lens[s:s + block]).to(device)
        nwin = w - k + 1
        key = torch.zeros((c.shape[0], nwin), dtype=torch.int64, device=device)
        bad = torch.zeros_like(key, dtype=torch.bool)
        for i in range(k):
            ch = c[:, i:i + nwin]
            key = key * 4 + (ch & 3)
            bad |= ch > 3
        inside = (torch.arange(nwin, device=device)[None, :] + k) <= ln[:, None]
        at = torch.searchsorted(tk, key).clamp(max=tk.numel() - 1)
        hit = (tk[at] == key) & inside & ~bad
        hc = hit.sum(dim=1)
        hv = torch.where(hit, tv[at], torch.zeros_like(key)).sum(dim=1)
        cnt[s:s + block] = hc.cpu().numpy()
        val[s:s + block] = hv.cpu().numpy()
    return cnt, np.where(cnt == 1, val, 0)


def expected_rows(whitelist: np.ndarray, seg: np.ndarray, seg_lens: np.ndarray,
                  is_na: np.ndarray, k: int, max_barcode_cnt: int, step_size: int,
                  thresh: float, device, forward_only: bool = False):
    """[(barcode index, count)] as the stage writes them."""
    keys, vals = word_table(whitelist, k, forward_only)
    cnt, val = row_hits(seg, seg_lens, keys, vals, k, device)
    use = (cnt == 1) & ~is_na
    bc = np.abs(val[use])
    counts = np.bincount(bc, minlength=whitelist.size)
    seen = np.flatnonzero(counts)
    first = np.full(whitelist.size, np.iinfo(np.int64).max)
    np.minimum.at(first, bc, np.arange(bc.size))
    ranked = seen[np.lexsort((first[seen], -counts[seen]))][:max_barcode_cnt]
    c = counts[ranked]
    if c.size == 0:
        return []
    total = int(c.sum())
    last = 0
    for last in range(0, c.size, step_size):
        if c[last:last + step_size].sum() / total < thresh:
            break
    keep = ranked[: last + step_size]
    return list(zip(keep.tolist(), counts[keep].tolist()))
