"""Plain-torch Myers twins (sctagger_tpu_torch.ops.myers) against the JAX
module (sctagger_tpu.ops.myers) on the same numpy-seeded inputs.

Tolerance: exact equality (all values are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs
from sctagger_tpu.ops import myers as jm
from sctagger_tpu_torch.ops import myers as tm

torch.set_num_threads(1)


def _inputs(m: int, seed: int, n_pat: int = 24, n_seg: int = 40):
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGT"))
    pats = ["".join(rng.choice(alpha, m)) for _ in range(n_pat)]
    segs = []
    for _ in range(n_seg):
        s = "".join(rng.choice(alpha, int(rng.integers(0, m + 20))))
        if rng.random() < 0.6:
            p = list(pats[int(rng.integers(n_pat))])
            for _ in range(int(rng.integers(0, 4))):
                p[int(rng.integers(m))] = str(rng.choice(alpha))
            at = int(rng.integers(0, len(s) + 1))
            s = s[:at] + "".join(p) + s[at:]
        if rng.random() < 0.1:
            s = s + "N"
        segs.append(s)
    pat_codes, _ = encode_seqs(pats, pad_to=m, table=LENIENT_TABLE)
    codes, _ = encode_seqs(segs, pad_to=2 * m + 24, table=LENIENT_TABLE)
    seg_T = codes.astype(np.int32).T.copy()
    seg_T[-1, ::7] = 9  # out-of-range codes match nothing in both packages
    return pat_codes, seg_T


@pytest.mark.parametrize("m", [12, 16, 31, 32])
def test_single_word_twins(m):
    pat_codes, seg_T = _inputs(m, seed=m)
    peq = tm.build_peq_multi(pat_codes)
    np.testing.assert_array_equal(peq, jm.build_peq_multi(pat_codes))
    assert tm.high_bit(m) == jm.high_bit(m)
    want = np.asarray(jm.match_block_min(jnp.asarray(seg_T), jnp.asarray(peq), m))
    got = tm.match_block_min(torch.from_numpy(seg_T), torch.from_numpy(peq), m)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [12, 16, 31, 32, 40])
def test_multi_word_twins(m):
    pat_codes, seg_T = _inputs(m, seed=100 + m)
    peq_w = tm.build_peq_multi_mw(pat_codes)
    np.testing.assert_array_equal(peq_w, jm.build_peq_multi_mw(pat_codes))
    seg_j, peq_j = jnp.asarray(seg_T), jnp.asarray(peq_w)
    seg_t, peq_t = torch.from_numpy(seg_T), torch.from_numpy(peq_w)
    np.testing.assert_array_equal(
        tm.match_block_min_mw(seg_t, peq_t, m).numpy(),
        np.asarray(jm.match_block_min_mw(seg_j, peq_j, m)),
    )
    np.testing.assert_array_equal(
        tm.match_best_mw_t(seg_t, peq_t, m).numpy(),
        np.asarray(jm.match_best_mw_t(seg_j, peq_j, m)),
    )


def test_step_and_eq_lookup_twins():
    """One column update of each package on the same random words, m=32
    (the score bit is the sign bit) and m=16."""
    rng = np.random.default_rng(5)
    words = rng.integers(-(2**31), 2**31, size=(4, 64), dtype=np.int64)
    pv, mv, eq, score = (w.astype(np.int32) for w in words)
    for m in (16, 32):
        want = jm._step(*(jnp.asarray(a) for a in (pv, mv, score, eq)), m, False)
        got = tm._step(*(torch.from_numpy(a) for a in (pv, mv, score, eq)), m)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    peq = rng.integers(-(2**31), 2**31, size=(5, 9), dtype=np.int64).astype(np.int32)
    c = np.array([0, 1, 2, 3, 4, 7, -1], np.int32)
    np.testing.assert_array_equal(
        tm._eq_lookup(tm._eq_table(torch.from_numpy(peq)), torch.from_numpy(c)).numpy(),
        np.asarray(jm._eq_lookup(jnp.asarray(peq), jnp.asarray(c))),
    )
