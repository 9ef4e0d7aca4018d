"""``match_trie``'s answer for chosen reads: the least infix edit distance
of each segment against every whitelist barcode and its reverse
complement, and every pattern at that distance when it is within
``max_error``. Pattern p = 2 * barcode + 1 is the forward barcode, 2 *
barcode its reverse complement; ties are listed by ascending p."""

from __future__ import annotations

import numpy as np
import torch

from .edit import infix_min


def patterns(barcodes: np.ndarray) -> np.ndarray:
    """(2B, bl) codes in pattern-id order."""
    rc = 3 - barcodes[:, ::-1]
    return np.stack([rc, barcodes], axis=1).reshape(-1, barcodes.shape[1])


def match_reads(barcodes: np.ndarray, seg: np.ndarray, seg_lens: np.ndarray,
                rows: np.ndarray, max_error: int, device, block: int = 512):
    """For each of ``rows``: (distance, tie pattern ids) when the distance
    is at most ``max_error``, else None."""
    pats = torch.from_numpy(patterns(barcodes).astype(np.int16)).to(device)
    out = []
    for s in range(0, rows.size, block):
        r = rows[s:s + block]
        texts = torch.from_numpy(seg[r].astype(np.int16)).to(device)
        lens = torch.from_numpy(seg_lens[r]).to(device)
        best = infix_min(pats, texts, lens)
        dmin = best.min(dim=1).values
        hit = (best == dmin[:, None]) & (dmin[:, None] <= max_error)
        dmin = dmin.cpu().numpy()
        rr, pp = [a.cpu().numpy() for a in torch.nonzero(hit, as_tuple=True)]
        ties = np.split(pp, np.searchsorted(rr, np.arange(1, r.size)))
        for i in range(r.size):
            out.append((int(dmin[i]), ties[i]) if dmin[i] <= max_error else None)
    return out
