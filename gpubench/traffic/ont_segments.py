"""ONT long-read segments for ``match_trie``, as ``extract_lr_bc`` cuts them.

A molecule, from the read's start: the adapter (10x's Read 1 primer), one
of the whitelist's barcodes, a random UMI (``umi_length``) and a poly(T)
run (``poly_t``), edited per base as ONT reads are (``seqs.edit_indel``:
``edits.rate``, sub:ins:del ``edits.weights``). The reference's
``filter_aln`` (reference/lr.py) cuts a '+'-strand read's segment at
s = max(0, min(locs) - 2), e = max(locs) + num_bp_after, where locs are the
optimal end positions of the adapter's infix alignment, and a '-'-strand
read's at the mirror of that from the reverse-complement adapter's starts.

Aligning the adapter in two million reads by ``end_scores`` would add tens
of seconds to every run's set-up, so the cut is drawn from a window model. ``derive_cut`` runs the reference's whole
rule (``expected_tsv``) on reads made the same way at a small size and
tallies each kept row's (strand, start, extra, dist): start = the
segment's first base, read forward, less the barcode's first position in
the edited molecule; extra = its length less num_bp_after + 2 (the spread
of the locs); dist the adapter's distance. The workload file holds the
shares (``params.assumed.cut``). ``generate`` gives a ``rc_share`` of the
rows the '-' strand, draws each row's triple from its strand's shares,
cuts the row's own edited molecule there, and reverse complements the '-'
rows, as a '-'-strand segment reaches match_trie. No NA rows, no random
segments. The whitelist is ``config.whitelist_barcodes`` distinct random
barcodes, drawn as the segments generator draws them.
"""

from __future__ import annotations

import numpy as np

from .. import seqs


def _codes(text: str) -> np.ndarray:
    return np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                           np.frombuffer(text.encode(), np.uint8)).astype(np.uint8)


def _molecules(rng, barcodes: np.ndarray, params: dict, config: dict):
    """Each row's edited adapter (rows, lengths) and the edited rest
    (barcode, UMI, poly(T)), edited apart so that the barcode's first
    position in the molecule, the adapter's edited length, is known."""
    n = barcodes.shape[0]
    adapter = _codes(config["adapter"])
    ed = params["edits"]
    rate, weights = float(ed["rate"]), ed["weights"]
    a_e, a_len = seqs.edit_indel(rng, np.broadcast_to(adapter, (n, adapter.size)),
                                 rate, weights)
    rest = np.concatenate([barcodes, seqs.random_codes(rng, (n, int(params["umi_length"]))),
                           np.full((n, int(params["poly_t"])), 3, np.uint8)], axis=1)
    r_e, r_len = seqs.edit_indel(rng, rest, rate, weights)
    return a_e, a_len, r_e, r_len


def _cut(a_e, a_len, r_e, r_len, s, lens) -> np.ndarray:
    """Bases s .. s + lens of each row's molecule (adapter, then rest),
    padded with PAD."""
    if (s < 0).any() or (s + lens > a_len + r_len).any():
        raise ValueError("a cut reaches past its molecule")
    cols = s[:, None] + np.arange(max(1, int(lens.max())))[None, :]
    a = np.take_along_axis(a_e, np.minimum(cols, a_e.shape[1] - 1), axis=1)
    rc = np.clip(cols - a_len[:, None], 0, r_e.shape[1] - 1)
    out = np.where(cols < a_len[:, None], a, np.take_along_axis(r_e, rc, axis=1))
    out[np.arange(cols.shape[1])[None, :] >= lens[:, None]] = seqs.PAD
    return out.astype(np.uint8)


def reads(n: int, seed: int, params: dict, config: dict):
    """Whole reads as extract_lr_bc sees them, for the reference's rule:
    10-39 random bases, the molecule (random barcodes), 30 random bases;
    the second half of the reads from the '-' strand (reverse complemented).
    Returns (the reference's data dict, the barcodes, the bases before each
    molecule, the adapter's edited lengths, '-' strand)."""
    rng = seqs.rng_for(seed, 7)
    bcs = seqs.random_codes(rng, (n, int(config["barcode_length"])))
    a_e, a_len, r_e, r_len = _molecules(rng, bcs, params, config)
    mlen = a_len + r_len
    mol = _cut(a_e, a_len, r_e, r_len, np.zeros(n, np.int64), mlen)
    head = rng.integers(10, 40, size=n)
    lens = head + mlen + 30
    w = int(lens.max())
    cols = np.arange(w)[None, :] - head[:, None]
    inside = (cols >= 0) & (cols < mlen[:, None])
    out = np.where(inside, np.take_along_axis(mol, np.clip(cols, 0, mol.shape[1] - 1), axis=1),
                   seqs.random_codes(rng, (n, w))).astype(np.uint8)
    minus = np.arange(n) >= n // 2
    out[minus] = seqs.revcomp_rows(out[minus], lens[minus])
    out[np.arange(w)[None, :] >= lens[:, None]] = seqs.PAD
    data = {"names": seqs.uuid_names(rng, n), "reads": out, "lens": lens}
    return data, bcs, head, a_len, minus


def derive_cut(n: int, seed: int, params: dict, config: dict, device) -> list:
    """The cut's shares by the reference's rule: ``n`` whole reads (half
    of them '-' strand) through reference/lr.py's expected_tsv, and of each
    row it keeps [strand (1: '-'), start, extra, dist, share], sorted.
    A '-' row's segment, reverse complemented, starts at -loc in the
    forward read; extra is its length less num_bp_after + 2."""
    from ..reference import lr as ref_lr

    data, _, head, a_len, _ = reads(n, seed, params, config)
    text = ref_lr.expected_tsv(data, config["adapter"], int(config["num_bp_after"]), device)
    rows = [ln.split(b"\t") for ln in text.splitlines()]
    kept = np.array([r[2] != b"NA" for r in rows])
    loc = np.array([int(r[2]) if k else 0 for r, k in zip(rows, kept)])
    dist = np.array([int(r[1]) for r in rows])
    seg_len = np.array([len(r[3]) for r in rows])
    minus = loc < 0
    start = np.where(minus, -loc, loc) - head - a_len
    trip = np.stack([minus, start, seg_len - int(config["num_bp_after"]) - 2, dist],
                    axis=1)[kept]
    uniq, counts = np.unique(trip, axis=0, return_counts=True)
    return [[*map(int, t), round(float(c) / kept.sum(), 9)] for t, c in zip(uniq, counts)]


def generate(params: dict, config: dict, seed: int) -> dict:
    rng = seqs.rng_for(seed, 1)
    n = int(config["segments_per_invocation"])
    bl = int(config["barcode_length"])
    keys = seqs.unique_kmers(rng, int(config["whitelist_barcodes"]), bl)
    barcodes = seqs.keys_to_codes(keys, bl)
    bid = rng.integers(0, barcodes.shape[0], size=n)
    a_e, a_len, r_e, r_len = _molecules(rng, barcodes[bid], params, config)

    is_rc = rng.random(n) < float(params["rc_share"])
    cut = np.asarray(params["assumed"]["cut"]["shares"], np.float64)
    start, extra, dist = np.zeros((3, n), np.int64)
    redraw = np.ones(n, bool)
    while redraw.any():  # a cut past its own molecule's ends: drawn again
        for strand, rows in ((0, redraw & ~is_rc), (1, redraw & is_rc)):
            table = cut[cut[:, 0] == strand]
            pick = rng.choice(table.shape[0], size=int(rows.sum()),
                              p=table[:, 4] / table[:, 4].sum())
            start[rows], extra[rows], dist[rows] = table[pick, 1:4].astype(np.int64).T
        s = a_len + start
        lens = int(config["num_bp_after"]) + 2 + extra
        redraw = (s < 0) | (s + lens > a_len + r_len)
    seg = _cut(a_e, a_len, r_e, r_len, s, lens)
    if is_rc.any():
        seg[is_rc] = seqs.revcomp_rows(seg[is_rc], lens[is_rc])
    sr_counts = np.sort(rng.integers(50, 20_000, size=barcodes.shape[0]))[::-1]
    return {
        "names": seqs.uuid_names(rng, n),
        "seg": seg,
        "seg_lens": lens,
        "dist": dist,
        # a '-'-strand read's loc counts back from the read's end
        "loc": np.where(is_rc, -s, s),
        "barcodes": barcodes,
        "sr_counts": sr_counts,
    }


if __name__ == "__main__":  # python3 -m gpubench.traffic.ont_segments N SEED
    import json
    import sys

    import torch

    from .. import manifest

    spec = manifest.cell("sr25k.match.ont")
    n, seed = int(sys.argv[1]), int(sys.argv[2])
    print(json.dumps(derive_cut(n, seed, spec["workload"]["params"], spec["config_data"],
                                torch.device("cpu"))))
