"""Long reads for ``extract_lr_bc``: random bases, lengths uniform in
[``len_min``, ``len_max``]; in ``adapter_share`` of them the short-read
adapter (``config.adapter``), each base edited at ``edits.rate`` by
substitution, insertion or deletion in the proportions ``edits.weights``
(seqs.edit_indel), starts ``0..offset_max`` bases from the strand's start,
on the forward strand or (``rc_share``) as its reverse complement that many
bases from the read's end."""

from __future__ import annotations

import numpy as np

from .. import seqs


def generate(params: dict, config: dict, seed: int) -> dict:
    rng = seqs.rng_for(seed, 3)
    n = int(config["reads_per_invocation"])
    lmin, lmax = int(params["len_min"]), int(params["len_max"])
    lens = rng.integers(lmin, lmax + 1, size=n).astype(np.int64)
    reads = seqs.random_codes(rng, (n, lmax))  # bases past a read's length unused

    adapter = np.frombuffer(config["adapter"].encode(), np.uint8)
    a = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), adapter).astype(np.uint8)
    m = a.size
    has = np.flatnonzero(rng.random(n) < float(params["adapter_share"]))
    ed = params["edits"]
    ad, ad_lens = seqs.edit_indel(rng, np.broadcast_to(a, (has.size, m)),
                                  float(ed["rate"]), ed["weights"])
    off = rng.integers(0, int(params["offset_max"]) + 1, size=has.size)
    rc = rng.random(has.size) < float(params["rc_share"])
    ad[rc] = seqs.revcomp_rows(ad[rc], ad_lens[rc])
    start = np.where(rc, lens[has] - off - ad_lens, off)
    j = np.arange(ad.shape[1])[None, :]
    r, c = np.nonzero(j < ad_lens[:, None])
    reads[has[r], start[r] + c] = ad[r, c]
    qual = rng.integers(ord("#"), ord("I") + 1, size=lmax, dtype=np.uint8)
    return {
        "names": seqs.uuid_names(rng, n),
        "reads": reads,
        "lens": lens,
        "qual": qual,
        "parts": int(config["fastq_parts"]),
    }
