"""Barcode segments for ``match_trie``: each segment is a whitelist barcode
(forward or reverse complement) between random flanks, edited by
substitutions only (``edits.model = "sub"``: k edits, k drawn from
``k_choices``) or by a per-base process of substitutions, insertions and
deletions (``"indel"``: ``rate`` per base, split by ``weights``), or a
random segment with no barcode (``random_share``). The whitelist is
``config.whitelist_barcodes`` distinct random barcodes."""

from __future__ import annotations

import numpy as np

from .. import seqs


def generate(params: dict, config: dict, seed: int) -> dict:
    rng = seqs.rng_for(seed, 1)
    n = int(config["segments_per_invocation"])
    bl = int(config["barcode_length"])
    flank = int(params["flank"])
    keys = seqs.unique_kmers(rng, int(config["whitelist_barcodes"]), bl)
    barcodes = seqs.keys_to_codes(keys, bl)

    bid = rng.integers(0, barcodes.shape[0], size=n)
    bc = barcodes[bid]
    ed = params["edits"]
    if ed["model"] == "sub":
        k = rng.choice(np.asarray(ed["k_choices"]), size=n)
        bc = seqs.substitute(rng, bc, seqs.pick_k_positions(rng, n, bl, k))
        bc_lens = np.full(n, bl, np.int64)
    elif ed["model"] == "indel":
        bc, bc_lens = seqs.edit_indel(rng, bc, float(ed["rate"]), ed["weights"])
    else:
        raise ValueError(f"unknown edit model {ed['model']!r}")

    left = seqs.random_codes(rng, (n, flank))
    right = seqs.random_codes(rng, (n, flank))
    mat = np.concatenate([left, bc, right], axis=1)
    keep = np.concatenate([
        np.ones((n, flank), bool),
        np.arange(bc.shape[1])[None, :] < bc_lens[:, None],
        np.ones((n, flank), bool),
    ], axis=1)
    seg, lens = seqs.compact_rows(mat, keep)

    is_random = rng.random(n) < float(params.get("random_share", 0.0))
    rand_len = 2 * flank + bl
    if is_random.any():
        seg[is_random] = seqs.PAD
        seg[is_random, :rand_len] = seqs.random_codes(rng, (int(is_random.sum()), rand_len))
        lens[is_random] = rand_len
    is_rc = rng.random(n) < float(params.get("rc_share", 0.0))
    if is_rc.any():
        seg[is_rc] = seqs.revcomp_rows(seg[is_rc], lens[is_rc])

    sr_counts = np.sort(rng.integers(50, 20_000, size=barcodes.shape[0]))[::-1]
    return {
        "names": seqs.uuid_names(rng, n),
        "seg": seg,
        "seg_lens": lens,
        "dist": rng.integers(0, 6, size=n),
        "loc": np.where(is_rc, -rng.integers(40, 80, size=n), rng.integers(20, 60, size=n)),
        "barcodes": barcodes,
        "sr_counts": sr_counts,
    }
