"""The port's entry point (sctagger_tpu_torch.entry) against the JAX
package's (__graft_entry__.entry, whose CPU branch is match_block_min), and
the matcher's tie-escalation best matrix (models/matcher._best_matrix_t,
routed through match_best) against the JAX package's _best_matrix_jnp_t.

Same numpy-seeded inputs on both sides, on the CPU. Tolerance: exact
equality (integer outputs)."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import sctagger_tpu_torch.models.matcher as tmatch
from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs
from sctagger_tpu.models import matcher as jmatch
from sctagger_tpu_torch import entry
from sctagger_tpu_torch.ops import match_cuda as mc

torch.set_num_threads(1)


def test_entry_matches_jax_entry():
    jfn, jargs = jax_entry.entry()
    want = np.asarray(jfn(*jargs))
    fn, args = entry.entry()
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    assert got.shape == (1, entry.READ_BLOCK) and got.dtype == torch.int32
    assert want.shape == (64,)
    np.testing.assert_array_equal(got[0, :64].numpy(), want)


def test_toy_problem_matches_jax():
    seg_codes, peq = entry._toy_problem()
    jseg, jpeq = jax_entry._toy_problem()
    np.testing.assert_array_equal(seg_codes.astype(np.int32).T, np.asarray(jseg))
    np.testing.assert_array_equal(peq, np.asarray(jpeq))


def _escalation_inputs(bl: int, n_reads: int, seed: int):
    """Reads of uneven length (ls up to bl + 12) over a whitelist whose
    pattern count is not a multiple of 256."""
    rng = np.random.default_rng(seed)
    bcs = ["".join("ACGT"[i] for i in rng.integers(0, 4, bl)) for _ in range(45)]
    segs = []
    for _ in range(n_reads):
        b = list(bcs[int(rng.integers(len(bcs)))])
        b[int(rng.integers(bl))] = "ACGT"[int(rng.integers(4))]
        pad = "".join("ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(0, 13))))
        segs.append(pad[: len(pad) // 2] + "".join(b) + pad[len(pad) // 2 :])
    codes, _ = encode_seqs(segs, pad_to=bl + 12, table=LENIENT_TABLE)
    ctx = tmatch.MatchContext(bcs)
    return codes, ctx.peq()


@pytest.mark.parametrize("bl,n_reads", [(16, 37), (32, 130)])
def test_best_matrix_t_matches_jnp(bl, n_reads):
    codes, peq = _escalation_inputs(bl, n_reads, seed=bl)
    want = np.asarray(jmatch._best_matrix_jnp_t(codes, peq, bl))
    before = mc.BEST_LAUNCHES
    got = tmatch._best_matrix_t(codes, peq, bl, torch.device("cpu"))
    assert mc.BEST_LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (90, n_reads)
    np.testing.assert_array_equal(got.numpy(), want)


def test_escalation_goes_through_match_best(monkeypatch):
    """Reads with more than 8 ties build their best matrix with match_best
    (the K5 wrapper), and the tie lists still equal the JAX package's."""
    calls = []
    real = tmatch.match_best

    def counting(seg_T, peq_pm, m):
        calls.append(tuple(seg_T.shape))
        return real(seg_T, peq_pm, m)

    monkeypatch.setattr(tmatch, "match_best", counting)
    rng = np.random.default_rng(5)
    core = "".join("ACGT"[i] for i in rng.integers(0, 4, 16))
    bcs = [core] * 10 + ["".join("ACGT"[i] for i in rng.integers(0, 4, 16)) for _ in range(30)]
    # two edits: past the host prefilter's reach (distance <= 1)
    near = core[:3] + "ACGT".replace(core[3], "")[0] + core[4:11] + core[12:]
    segs = ["GG" + near + "CA" for _ in range(3)] + ["ACGT" * 6]
    got = tmatch.match_segments(segs, bcs, 2, device="cpu")
    want = jmatch.match_segments(segs, bcs, 2)
    assert calls, "escalation did not call match_best"
    np.testing.assert_array_equal(got.rids, want.rids)
    np.testing.assert_array_equal(got.tie_counts, want.tie_counts)
    for i in range(got.rids.size):
        np.testing.assert_array_equal(got.ties_of(i), want.ties_of(i))
    assert (got.tie_counts > mc.TIES_K).any()
    assert (got.dists[got.tie_counts > mc.TIES_K] == 2).all()
