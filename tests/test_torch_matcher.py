"""The port's match_segments (sctagger_tpu_torch.models.matcher) against the
JAX package's (sctagger_tpu.models.matcher) on the same numpy-seeded
whitelists and segments, on the CPU.

Compared: matched read ids, distances, tie counts and every tie list
(through ties_of; slots past the count are unspecified). Tolerance: exact
equality. PASS1_CHUNK is shrunk so the port's streaming loop runs several
slices, survivor repacks and chunks."""

import numpy as np
import pytest
import torch

import sctagger_tpu_torch.models.matcher as tmatch
from sctagger_tpu.core.packing import rev_compl
from sctagger_tpu.models import matcher as jmatch
from sctagger_tpu.observability import StageStats

torch.set_num_threads(1)


def _mutate(rng, s: str, k: int) -> str:
    b = list(s)
    for _ in range(k):
        op = int(rng.integers(3))
        at = int(rng.integers(len(b)))
        if op == 0:
            b[at] = "ACGT"[int(rng.integers(4))]
        elif op == 1 and len(b) > 1:
            del b[at]
        else:
            b.insert(at, "ACGT"[int(rng.integers(4))])
    return "".join(b)


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _inputs(bl: int, mr: int, seed: int):
    """A whitelist with a near-duplicate cluster around a core barcode that
    also appears ten times, and a reverse-complement pair; reads that are
    empty, all-N, short, on the core, concatenations of barcodes, and long
    segments with several planted barcodes."""
    rng = np.random.default_rng(seed)
    core = _dna(rng, bl)
    bcs = [core]
    while len(bcs) < 12:
        b = list(core)
        b[int(rng.integers(bl))] = "ACGT"[int(rng.integers(4))]
        if "".join(b) not in bcs:
            bcs.append("".join(b))
    pair = _dna(rng, bl)
    bcs += [pair, rev_compl(pair)]
    while len(bcs) < 40:
        bcs.append(_dna(rng, bl))
    bcs += [core] * 9  # duplicates: reads on the core tie > TIES_K times
    segs = []
    for _ in range(150):
        kind = rng.random()
        if kind < 0.06:
            seg = ""
        elif kind < 0.1:
            seg = "N" * int(rng.integers(1, 2 * bl))
        elif kind < 0.16:
            seg = _dna(rng, int(rng.integers(1, max(2, bl - mr))))
        elif kind < 0.36:
            seg = _dna(rng, 3) + _mutate(rng, core, int(rng.integers(0, mr + 1))) + _dna(rng, 2)
        elif kind < 0.44:
            seg = "".join(bcs[int(rng.integers(len(bcs)))] for _ in range(3))
        elif kind < 0.52:
            seg = _dna(rng, int(rng.integers(60, 100)))
            for _ in range(2):
                b = bcs[int(rng.integers(len(bcs)))]
                at = int(rng.integers(len(seg)))
                seg = seg[:at] + _mutate(rng, rev_compl(b), int(rng.integers(0, mr + 2))) + seg[at:]
        else:
            b = bcs[int(rng.integers(len(bcs)))]
            if rng.random() < 0.5:
                b = rev_compl(b)
            seg = _dna(rng, int(rng.integers(0, 6))) + _mutate(rng, b, int(rng.integers(0, mr + 2))) + _dna(rng, int(rng.integers(0, 6)))
        segs.append(seg)
    return segs, bcs


def _summary(r):
    return (
        r.rids.tolist(),
        np.asarray(r.dists).tolist(),
        r.tie_counts.tolist(),
        [r.ties_of(i).tolist() for i in range(r.rids.size)],
    )


CASES = [(bl, mr, "1") for bl in (12, 16, 20, 40) for mr in (0, 1, 2, 3)]
CASES += [(bl, 2, "0") for bl in (12, 16, 20)]


@pytest.mark.parametrize("bl,mr,prefilter", CASES)
def test_match_segments_matches_jax(bl, mr, prefilter, monkeypatch):
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", prefilter)
    monkeypatch.setattr(tmatch, "PASS1_CHUNK", 48)
    segs, bcs = _inputs(bl, mr, seed=1000 * bl + mr)
    want = _summary(jmatch.match_segments(segs, bcs, max_error=mr))
    got = _summary(tmatch.match_segments(segs, bcs, max_error=mr, device="cpu"))
    assert got == want
    assert max(want[2]) > tmatch.TIES_K  # tie-overflow escalation covered


def test_uniform_chunks_take_match_full(monkeypatch):
    """Chunks of one segment length go through match_full (K1), ragged ones
    through match_full_dynls (K2); both give the JAX package's output."""
    calls = {"match_full": 0, "match_full_dynls": 0}
    for name in calls:
        fn = getattr(tmatch, name)

        def spy(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tmatch, name, spy)
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", "0")
    rng = np.random.default_rng(9)
    segs, bcs = _inputs(16, 2, seed=9)
    uniform = [(_dna(rng, 4) + s + _dna(rng, 24))[:24] for s in segs]
    for reads, want_calls in ((uniform, (1, 0)), (segs, (0, 1))):
        calls.update(match_full=0, match_full_dynls=0)
        want = _summary(jmatch.match_segments(reads, bcs, max_error=2))
        got = _summary(tmatch.match_segments(reads, bcs, max_error=2, device="cpu"))
        assert got == want
        assert (calls["match_full"], calls["match_full_dynls"]) == want_calls


@pytest.mark.parametrize("prefilter", ["0", "1"])
def test_stats_count_escalated_reads(prefilter, monkeypatch):
    """``escalated_reads`` is the number of device-swept matched reads with
    more than TIES_K ties (prefilter-resolved reads carry full tie sets and
    never escalate)."""
    monkeypatch.setenv("SCTAG_EXACT_PREFILTER", prefilter)
    segs, bcs = _inputs(16, 2, seed=5)
    stats = StageStats("match")
    r = tmatch.match_segments(segs, bcs, max_error=2, device="cpu", stats=stats)
    over = int((r.tie_counts > tmatch.TIES_K).sum())
    c = stats.counters
    assert c["prefilter_resolved"] + c["device_reads"] == len(segs)
    if prefilter == "0":
        assert c["escalated_reads"] == over > 0
    else:
        assert 0 <= c["escalated_reads"] <= over


def test_match_context_from_jax_arrays(monkeypatch):
    """The port's context equals the JAX context byte for byte, and a port
    context built on the JAX context's arrays matches identically."""
    monkeypatch.setattr(tmatch, "PASS1_CHUNK", 64)
    segs, bcs = _inputs(16, 2, seed=77)
    jctx = jmatch.MatchContext(bcs)
    own = tmatch.MatchContext(bcs)
    assert own.pat_codes.dtype == jctx.pat_codes.dtype
    assert own.pat_codes.tobytes() == jctx.pat_codes.tobytes()
    assert own.peq().dtype == jctx.peq().dtype
    assert own.peq().tobytes() == jctx.peq().tobytes()
    ctx = tmatch.MatchContext.from_arrays(bcs, jctx.pat_codes, jctx.peq())
    want = _summary(jmatch.match_segments(segs, bcs, max_error=2, ctx=jctx))
    got = _summary(tmatch.match_segments(segs, bcs, max_error=2, ctx=ctx, device="cpu"))
    assert got == want


def test_match_segments_empty_input():
    r = tmatch.match_segments([], ["ACGTACGTACGTACGT"], max_error=2, device="cpu")
    assert r.rids.size == 0 and r.tie_slots.shape == (0, tmatch.TIES_K)
