"""Stage-1 output rows for ``extract_sr_bc_from_lr``: a share of rows with
no adapter (``NA``); the rest carry a 24 bp segment, a barcode between
random flanks (forward or reverse complement), which is an exact barcode of
one of ``cells`` cells drawn from the whitelist with Zipf(``zipf_s``)
abundance, an exact ambient barcode drawn uniformly from the whitelist, or
a cell barcode with 1 to ``mutated_max_subs`` substitutions. The whitelist
is ``config.whitelist_barcodes`` distinct random barcodes."""

from __future__ import annotations

import numpy as np

from .. import seqs


def generate(params: dict, config: dict, seed: int) -> dict:
    rng = seqs.rng_for(seed, 2)
    n = int(config["lr_rows_per_invocation"])
    bl = int(config["barcode_length"])
    flank = int(params["flank"])
    wl = seqs.unique_kmers(rng, int(config["whitelist_barcodes"]), bl)
    cells = rng.choice(wl.size, size=int(params["cells"]), replace=False)

    shares = params["shares"]  # of the rows with a segment
    kinds = rng.choice(3, size=n, p=[shares["cell"], shares["ambient"], shares["mutated"]])
    is_na = rng.random(n) < float(params["na_share"])
    cell_pick = cells[seqs.zipf_choice(rng, cells.size, float(params["zipf_s"]), n)]
    ambient = rng.integers(0, wl.size, size=n)
    bid = np.where(kinds == 1, ambient, cell_pick)
    bc = seqs.keys_to_codes(wl[bid], bl)
    k = rng.integers(1, int(params["mutated_max_subs"]) + 1, size=n)
    k = np.where(kinds == 2, k, 0)
    bc = seqs.substitute(rng, bc, seqs.pick_k_positions(rng, n, bl, k))
    seg = np.concatenate([seqs.random_codes(rng, (n, flank)), bc,
                          seqs.random_codes(rng, (n, flank))], axis=1)
    lens = np.full(n, seg.shape[1], np.int64)
    is_rc = rng.random(n) < float(params["rc_share"])
    seg[is_rc] = seqs.revcomp_rows(seg[is_rc], lens[is_rc])
    seg[is_na] = seqs.PAD
    lens[is_na] = 0
    return {
        "names": seqs.uuid_names(rng, n),
        "is_na": is_na,
        "seg": seg,
        "seg_lens": lens,
        "dist": rng.integers(0, 6, size=n),
        "loc": np.where(is_rc, -rng.integers(40, 80, size=n), rng.integers(20, 60, size=n)),
        "whitelist": wl,
    }
