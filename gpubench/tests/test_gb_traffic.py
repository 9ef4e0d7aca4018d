"""The generators: same seed, same inputs; every seed, the same sizes; and
the shares each workload states."""

import numpy as np
import pytest
import torch

from gpubench import manifest, seqs
from gpubench.reference import lr as ref_lr
from gpubench.reference import match as ref_match
from gpubench.tests.small import SMALL

CELLS = sorted(SMALL)
CPU = torch.device("cpu")


def _gen(cell, seed, config=None, params=None):
    spec = manifest.cell(cell)
    w = spec["workload"]
    conf = {**spec["config_data"], **SMALL[cell]["config"], **(config or {})}
    par = {**w["params"], **SMALL[cell]["params"], **(params or {})}
    return manifest.module("traffic", w["generator"]).generate(par, conf, seed), conf, par


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs_and_sizes(cell):
    a, _, _ = _gen(cell, 2**31 + 7)
    b, _, _ = _gen(cell, 2**31 + 7)
    c, _, _ = _gen(cell, 11)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        assert np.shape(a[k]) == np.shape(c[k]) or k in ("seg",), k
    assert any(not np.array_equal(np.asarray(a[k]), np.asarray(c[k])) for k in a)


def _hamming_k(d, bl, flank):
    """Substitutions per forward segment: Hamming distance of its barcode
    window to the nearest whitelist barcode."""
    win = d["seg"][:, flank:flank + bl]
    return (win[:, None, :] != d["barcodes"][None, :, :]).sum(2).min(1)


def test_sub_segments_carry_0_1_2_substitutions_uniformly():
    d, conf, par = _gen("sr25k.match.sub", 3, config={"whitelist_barcodes": 50})
    k = _hamming_k(d, conf["barcode_length"], par["flank"])
    share = np.bincount(k, minlength=3)[:3] / k.size
    assert np.all(np.abs(share - 1 / 3) < 0.04), share
    assert (d["seg_lens"] == 24).all()


# an ONT-like mix of the segments generator (the sr25k.match.ont cell of
# PERF.md's open questions)
ONT = {"edits": {"model": "indel", "rate": 0.10, "weights": [1, 1, 1]},
       "random_share": 0.2, "rc_share": 0.5}


def test_ont_segments_edit_rate_random_and_rc_shares():
    d, conf, par = _gen("sr25k.match.sub", 4, params=ONT,
                        config={"whitelist_barcodes": 40, "segments_per_invocation": 2000})
    lens = d["seg_lens"]
    assert abs(lens.mean() - 24) < 0.3  # insertions balance deletions
    assert 0.2 < (lens != 24).mean() < 0.7  # 1.07 indels a barcode, Poisson
    best = ref_match.match_reads(d["barcodes"], d["seg"], lens, np.arange(lens.size), 16,
                                 torch.device("cpu"), block=500)
    dist = np.array([g[0] for g in best])
    rc = np.array([g[1][0] % 2 == 0 for g in best])
    near = dist <= 4
    # most of the 20% random segments sit 5 or more edits from every barcode
    assert 0.10 < (~near).mean() < 0.22
    assert abs(rc[near].mean() - 0.5) < 0.05
    assert abs(dist[near].mean() - 1.6 * 0.95) < 0.35  # ~16 x 0.10 edits, some cancel


def test_lr_rows_na_cells_and_abundance():
    d, conf, par = _gen("wl3m.alt.probe", 5, config={"lr_rows_per_invocation": 40000})
    assert abs(d["is_na"].mean() - 0.1) < 0.01
    k = conf["barcode_length"]
    wl = set(d["whitelist"].tolist())
    ok = ~d["is_na"]
    seg = d["seg"][ok]
    fwd = seqs.codes_to_keys(seg[:, 4:4 + k])
    rc = seqs.codes_to_keys(seqs.revcomp_rows(seg, np.full(len(seg), 24))[:, 4:4 + k])
    exact = np.array([a in wl or b in wl for a, b in zip(fwd.tolist(), rc.tolist())])
    assert abs(exact.mean() - 0.8) < 0.02  # cell 70% + ambient 10%
    is_fwd = np.isin(fwd, d["whitelist"])
    keys = np.where(is_fwd, fwd, rc)[exact]
    _, counts = np.unique(keys, return_counts=True)
    h = (1.0 / np.arange(1, par["cells"] + 1)).sum()
    assert abs(counts.max() / (0.7 / 0.8 * exact.sum()) - 1 / h) < 0.02  # Zipf(1) head
    assert abs(is_fwd[exact].mean() - 0.5) < 0.02


def test_reads_adapter_share_strand_and_offset():
    d, conf, par = _gen("sr25k.lr.scan", 6, config={"reads_per_invocation": 3000})
    a = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                        np.frombuffer(conf["adapter"].encode(), np.uint8)).astype(np.int16)
    m = a.size
    reads, lens = d["reads"], d["lens"]
    assert lens.min() >= par["len_min"] and lens.max() <= par["len_max"]
    w = par["offset_max"] + 2 * m  # the adapter, with insertions, lies inside
    head = reads[:, :w]
    tail = np.stack([reads[i, lens[i] - w:lens[i]] for i in range(lens.size)])
    win = np.full(lens.size, w)
    f = ref_lr.end_scores(a[None, :], head, win, CPU)[0][0]
    r = ref_lr.end_scores((3 - a[::-1])[None, :], tail, win, CPU)[0][0]
    has_f, has_r = f <= 5, r <= 5
    assert abs((has_f | has_r).mean() - par["adapter_share"]) < 0.02
    assert abs(has_r[has_f | has_r].mean() - par["rc_share"]) < 0.03
    # the edit distance is at most the edits made (m x rate on average), and
    # close to it at this rate
    got = np.minimum(f, r)[has_f | has_r].mean()
    assert m * par["edits"]["rate"] - 0.3 < got <= m * par["edits"]["rate"] + 0.1


def test_edit_indel_shares():
    rng = seqs.rng_for(5, 0)
    codes = seqs.random_codes(rng, (20000, 22))
    out, lens = seqs.edit_indel(rng, codes, 0.1, [1, 1, 1])
    assert abs(lens.mean() - 22) < 0.05  # insertions and deletions balance
    assert abs((lens > 22).mean() - (lens < 22).mean()) < 0.02
    subs, _ = seqs.edit_indel(rng, codes, 0.1, [1, 0, 0])
    assert abs((subs[:, :22] != codes).mean() - 0.1) < 0.005  # substitutions only
