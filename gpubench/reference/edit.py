"""Edit-distance DP by columns, in plain torch.

``dp_columns`` runs the textbook DP of each pattern against each text, one
text column at a time: D[i][j] = min(D[i-1][j-1] + (p[i] != t[j]),
D[i-1][j] + 1, D[i][j-1] + 1), D[i][0] = i. Row 0 is 0 in every column for
an infix (HW) alignment, where the text's leading gap is free, and j for a
prefix (SHW) alignment. The vertical term is a running minimum down the
column, new[i] = min(cand[i], new[i-1] + 1), taken row by row.
"""

from __future__ import annotations

import torch


def dp_columns(pats: torch.Tensor, texts: torch.Tensor, shw: bool = False,
               pairwise: bool = False):
    """Yield (j, scores) for each text column j, scores (S, P) int16 the
    distance of the whole pattern against a text ending at column j (with
    ``pairwise``, pattern s against text s only: scores (S,)), valid until
    the next column is asked for.

    pats (P, m) codes 0-3; texts (S, W) codes, any value >= 4 matching
    nothing. The caller masks columns past each text's length."""
    S, W = texts.shape
    m = pats.shape[1]
    dev = texts.device
    pt = pats.to(dev, torch.int16).T  # (m, P)
    pt = pt[:, :, None] if pairwise else pt[:, None, :]  # (m, S, 1) or (m, 1, P)
    P = 1 if pairwise else pats.shape[0]
    D = torch.arange(m + 1, dtype=torch.int16, device=dev).view(m + 1, 1, 1).expand(m + 1, S, P)
    D = D.clone()
    E = torch.empty_like(D)
    for j in range(W):
        cost = (pt != texts[:, j].to(torch.int16).view(1, S, 1)).to(torch.int16)
        torch.minimum(D[:-1] + cost, D[1:] + 1, out=E[1:])
        E[0] = j + 1 if shw else 0
        for i in range(1, m + 1):
            torch.minimum(E[i], E[i - 1] + 1, out=E[i])
        D, E = E, D
        yield j, (D[m, :, 0] if pairwise else D[m])


def infix_min(pats: torch.Tensor, texts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(S, P) least infix distance of each pattern in each text's first
    lens[s] columns (a pattern against an empty text: m)."""
    S = texts.shape[0]
    m = pats.shape[1]
    best = torch.full((S, pats.shape[0]), m, dtype=torch.int16, device=texts.device)
    for j, sc in dp_columns(pats, texts):
        live = (j < lens)[:, None]
        best = torch.where(live, torch.minimum(best, sc), best)
    return best
