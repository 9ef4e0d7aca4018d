"""The sr25k.match.ont cell at a small size of its own: its generator
against reference/lr.py's filter_aln rule (segment lengths and strands),
a sound run that is correct, the timed path broken underneath (a distance
altered, half the segments left out) that is not, and the band control
failing the check."""

import time

import numpy as np
import pytest
import torch

from gpubench import harness, manifest, seqs
from gpubench.control import control_readings
from gpubench.reference import lr as ref_lr
from gpubench.tests.test_gb_faults import _match_alter, _match_half
from gpubench.traffic import ont_segments

CELL = "sr25k.match.ont"
SMALL = {"config": {"segments_per_invocation": 3000, "whitelist_barcodes": 300},
         "params": {"warm_rows": 200, "check_sample": 400}}
SEED = 2**31 + 77
CPU = torch.device("cpu")
SPEC = manifest.cell(CELL)


def _conf(**over):
    return {**SPEC["config_data"], **SMALL["config"], **over}


def _params(**over):
    return {**SPEC["workload"]["params"], **SMALL["params"], **over}


def _rule_rows(params, config, n, seed=5):
    """Whole reads (ont_segments.reads, half '-' strand) through the
    reference's extract_lr_bc answer: each row's kept flag, '-' strand and
    segment, and the reads' barcodes."""
    data, bcs, _, _, minus = ont_segments.reads(n, seed, params, config)
    text = ref_lr.expected_tsv(data, config["adapter"], int(config["num_bp_after"]), CPU)
    rows = [ln.split(b"\t") for ln in text.splitlines()]
    kept = np.array([r[2] != b"NA" for r in rows])
    neg = np.array([r[2].startswith(b"-") for r in rows])
    assert (neg[kept] == minus[kept]).all()  # each read keeps its own strand
    return kept, neg, [r[3] for r in rows], bcs


def _revcomp(b: bytes) -> bytes:
    return b[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


def _len_shares(lens) -> np.ndarray:
    return np.bincount(np.asarray(lens) - 22, minlength=16)[:16] / len(lens)


def test_lengths_follow_the_filter_aln_rule():
    """At the workload's edit rate, the generator's segment lengths (22 +
    the spread of the adapter's optimal ends) are distributed as the
    reference's on whole reads, on either strand."""
    params, config = _params(), _conf(segments_per_invocation=20000)
    kept, neg, segs, _ = _rule_rows(params, config, n=6000)
    assert 0.97 < kept.mean() <= 1.0
    d = ont_segments.generate(params, config, SEED)
    assert d["seg_lens"].min() == 22
    for strand in (False, True):
        gen = _len_shares(d["seg_lens"][(d["loc"] < 0) == strand])
        rule = _len_shares([len(s) for s, k, g in zip(segs, kept, neg) if k and g == strand])
        assert np.abs(rule - gen).sum() / 2 < 0.02, (strand, rule, gen)


def _oriented(segs, minus, wl) -> tuple[float, float]:
    """Shares of rows holding a whitelist barcode whole: read forward
    (a '-' row reverse complemented), and read the other way."""
    def holds(b):
        return any(b[i:i + 16] in wl for i in range(len(b) - 15))
    right = [holds(_revcomp(s) if m else s) for s, m in zip(segs, minus)]
    wrong = [holds(s if m else _revcomp(s)) for s, m in zip(segs, minus)]
    return float(np.mean(right)), float(np.mean(wrong))


def test_strands_follow_the_filter_aln_rule():
    """A '-'-strand row holds its barcode reverse complemented, in the
    reference on whole reads as in the generator (substitutions at 1%, so
    most barcodes stay whole), and the generator's '-' rows are its
    rc_share."""
    params = _params(edits={"rate": 0.01, "weights": [1, 0, 0]})
    config = _conf()
    kept, neg, segs, bcs = _rule_rows(params, config, n=2000)
    assert kept.mean() > 0.9 and 0.45 < neg[kept].mean() < 0.55
    wl = set(seqs.decode_rows(bcs, np.full(len(bcs), bcs.shape[1])))
    right, wrong = _oriented([s for s, k in zip(segs, kept) if k], neg[kept], wl)
    assert right > 0.8 and wrong < 0.01

    d = ont_segments.generate(params, config, SEED)
    rc = d["loc"] < 0
    assert 0.45 < rc.mean() < 0.55
    wl = set(seqs.decode_rows(d["barcodes"], np.full(len(d["barcodes"]), 16)))
    right, wrong = _oriented(seqs.decode_rows(d["seg"], d["seg_lens"]), rc, wl)
    assert right > 0.8 and wrong < 0.01


def _run():
    return harness.run_cell(CELL, SEED, 1.0, False, time.perf_counter(), device="cpu",
                            overrides=SMALL)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("fault", [_match_alter, _match_half], ids=["alter", "half"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from sctagger_tpu_torch.stages import match_trie

    monkeypatch.setattr(match_trie, "match_segments", fault(match_trie.match_segments))
    r = _run()
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_band_control_fails_the_check():
    for seed in (1, 2, 3):
        r = control_readings(CELL, seed, CPU, SMALL)
        assert r["checks"]["rows_wrong"]["value"] > r["checks"]["rows_wrong"]["limit"]
