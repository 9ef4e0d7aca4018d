"""The port's copy of the host prefilter (sctagger_tpu_torch.ops
.exact_prefilter) against the original (sctagger_tpu.ops.exact_prefilter):
exact_tie_probe and NeighborhoodIndex.probe on the same numpy-seeded reads.

Tolerance: exact equality of every output array."""

import dataclasses

import numpy as np
import pytest

from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs, rev_compl
from sctagger_tpu.ops import exact_prefilter as orig
from sctagger_tpu_torch.ops import exact_prefilter as port


def _inputs(bl: int, seed: int):
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGT"))
    pats = ["".join(rng.choice(alpha, bl)) for _ in range(60)]
    pats[3] = pats[0]  # duplicate pattern id
    pats[7] = rev_compl(pats[1])  # reverse-complement collision
    segs = []
    for _ in range(400):
        body = "".join(rng.choice(alpha, int(rng.integers(0, 3 * bl))))
        if rng.random() < 0.7:
            p = list(pats[int(rng.integers(len(pats)))])
            for _ in range(int(rng.integers(0, 3))):
                op = int(rng.integers(3))
                at = int(rng.integers(len(p)))
                if op == 0:
                    p[at] = str(rng.choice(alpha))
                elif op == 1:
                    del p[at]
                else:
                    p.insert(at, str(rng.choice(alpha)))
            at = int(rng.integers(0, len(body) + 1))
            body = body[:at] + "".join(p) + body[at:]
        if rng.random() < 0.1:
            body = body[: len(body) // 2] + "N" + body[len(body) // 2 :]
        segs.append(body)
    pat_codes, _ = encode_seqs(pats, pad_to=bl, table=LENIENT_TABLE)
    pad = max(1, max(len(s) for s in segs))
    seg_codes, lens = encode_seqs(segs, pad_to=pad, table=LENIENT_TABLE)
    return pat_codes, seg_codes, lens


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


@pytest.mark.parametrize("bl", [12, 16, 20, 31])
def test_exact_tie_probe_matches_original(bl):
    pat_codes, seg_codes, lens = _inputs(bl, seed=bl)
    got = port.exact_tie_probe(seg_codes, lens, pat_codes)
    assert got.rids.size > 0
    _assert_same(got, orig.exact_tie_probe(seg_codes, lens, pat_codes))


@pytest.mark.parametrize("bl", [12, 16, 20, 31])
def test_neighborhood_probe_matches_original(bl):
    pat_codes, seg_codes, lens = _inputs(bl, seed=50 + bl)
    got = port.NeighborhoodIndex(pat_codes).probe(seg_codes, lens)
    assert (got.dists == 1).any() and (got.dists == 0).any()
    _assert_same(got, orig.NeighborhoodIndex(pat_codes).probe(seg_codes, lens))
