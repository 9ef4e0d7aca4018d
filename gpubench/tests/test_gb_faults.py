"""A run judges what the timed path produces: the harness run on the CPU at
a small size (its look for a card skipped), first sound, then with the
program broken underneath, once for each fault a cell can have: an answer
altered where it is produced, and half of the batch left out. Each broken
run must come out not correct; the sound one correct. The controls (the
reference of a lower guarantee in the program's place) fail the check."""

import time

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.control import control_readings
from gpubench.tests.small import SMALL

SEED = 2**31 + 99


def run(cell):
    return harness.run_cell(cell, SEED, 1.0, False, time.perf_counter(), device="cpu",
                            overrides=SMALL[cell])


def _match_alter(orig):
    def f(*a, **kw):
        r = orig(*a, **kw)
        if r.rids.size:
            r.dists[0] += 1
        return r
    return f


def _match_half(orig):
    def f(*a, segments, **kw):
        return orig(*a, segments=segments[: len(segments) // 2], **kw)
    return f


def _lr_alter(orig):
    def f(*a, **kw):
        names, seqs, scan = orig(*a, **kw)
        i = int(np.flatnonzero(scan.strands >= 0)[0])
        scan.dists[i] += 1
        return names, seqs, scan
    return f


def _lr_half(orig):
    def f(*a, **kw):
        names, seqs, scan = orig(*a, **kw)
        scan.strands[len(scan.strands) // 2:] = -1
        return names, seqs, scan
    return f


def _alt_alter(orig):
    def f(*a, **kw):
        counts, vals = orig(*a, **kw)
        i = int(np.flatnonzero(counts == 1)[0])
        vals[i] = vals[i] + 1 if vals[i] >= 0 else vals[i] - 1
        return counts, vals
    return f


def _alt_half(orig):
    def f(*a, **kw):
        counts, vals = orig(*a, **kw)
        counts[len(counts) // 2:] = 0
        return counts, vals
    return f


FAULTS = {
    "sr25k.match.sub": ("match_trie", "match_segments", _match_alter, _match_half),
    "sr25k.lr.scan": ("extract_lr_bc", "scan_adapters_stream", _lr_alter, _lr_half),
    "wl3m.alt.probe": ("extract_sr_bc_from_lr", "probe_segments", _alt_alter, _alt_half),
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("fault", ["alter", "half"])
@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    stage, fn, alter, half = FAULTS[cell]
    mod = importlib.import_module(f"sctagger_tpu_torch.stages.{stage}")
    wrap = alter if fault == "alter" else half
    monkeypatch.setattr(mod, fn, wrap(getattr(mod, fn)))
    r = run(cell)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_control_fails_the_check(cell):
    for seed in (1, 2, 3):
        r = control_readings(cell, seed, torch.device("cpu"), SMALL[cell])
        assert r["checks"]["rows_wrong"]["value"] > r["checks"]["rows_wrong"]["limit"]
