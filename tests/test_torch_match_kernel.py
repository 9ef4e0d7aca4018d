"""The match kernel's plain versions (sctagger_tpu_torch.ops.match_cuda)
against the Pallas kernels they port, run in interpret mode on the CPU
(match_full_tpu / match_full_dynls_tpu with interpret=True).

Both packages pad patterns to a multiple of 256 with all-zero Peq rows, so
the full (TIES_K + 2, R_pad) rows are compared, padding included.
Tolerance: exact equality (all values are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs, rev_compl
from sctagger_tpu.ops import match_pallas as jp
from sctagger_tpu_torch.models.matcher import MatchContext
from sctagger_tpu_torch.ops import match_cuda as mc

torch.set_num_threads(1)

R = 2048
N_BC = 300  # -> 600 patterns, padded to 768


def _case(m: int, ls: int, ragged: bool, seed: int):
    """Reads with planted (mutated, possibly reverse-complement) barcodes;
    one barcode appears ten times in the whitelist, so reads carrying it
    overflow the 8 tie slots."""
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGT"))
    core = "".join(rng.choice(alpha, m))
    bcs = [core] * 10 + ["".join(rng.choice(alpha, m)) for _ in range(N_BC - 10)]
    segs = []
    for i in range(R - 5):  # leaves padded read columns
        n = int(rng.integers(ls // 2, ls + 1)) if ragged else ls
        s = "".join(rng.choice(alpha, n))
        b = core if i % 9 == 0 else bcs[int(rng.integers(N_BC))]
        if rng.random() < 0.5:
            b = rev_compl(b)
        b = list(b)
        for _ in range(int(rng.integers(0, 3))):
            b[int(rng.integers(m))] = str(rng.choice(alpha))
        at = int(rng.integers(0, max(1, n - m + 1)))
        segs.append((s[:at] + "".join(b) + s[at:])[:n])
    ctx = MatchContext(bcs)
    codes, lens = encode_seqs(segs, pad_to=ls, table=LENIENT_TABLE)
    seg_T = mc.prep_segs_T(codes, ls)
    np.testing.assert_array_equal(seg_T, jp.prep_segs_T(codes, ls))
    peq_pm = mc.prep_peq_cols(ctx.peq())
    np.testing.assert_array_equal(peq_pm, jp.prep_peq_cols(ctx.peq()))
    return seg_T, peq_pm, lens


@pytest.mark.parametrize("m,ls", [(16, 24), (31, 40), (32, 40)])
def test_match_full_ref_vs_pallas(m, ls):
    seg_T, peq_pm, lens = _case(m, ls, ragged=False, seed=m)
    want = np.asarray(
        jp.match_full_tpu(jnp.asarray(seg_T), jnp.asarray(peq_pm), m, interpret=True)
    )
    got = mc.match_full_ref(torch.from_numpy(seg_T), torch.from_numpy(peq_pm), m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1, : lens.size] > mc.TIES_K).any()  # tie overflow covered


@pytest.mark.parametrize("m,ls", [(16, 40), (32, 56)])
def test_match_full_dynls_ref_vs_pallas(m, ls):
    seg_T, peq_pm, lens = _case(m, ls, ragged=True, seed=100 + m)
    order = np.argsort(lens, kind="stable")  # length-sorted, as the matcher
    seg_T = np.ascontiguousarray(seg_T[:, np.r_[order, lens.size : seg_T.shape[1]]])
    ml = np.zeros(seg_T.shape[1], np.int32)
    ml[: lens.size] = lens[order]
    ml = ml.reshape(1, -1, mc.DEF_BR).max(axis=2)
    assert ml.min() < ls  # a block really stops early
    want = np.asarray(
        jp.match_full_dynls_tpu(
            jnp.asarray(seg_T), jnp.asarray(peq_pm), jnp.asarray(ml), m,
            interpret=True,
        )
    )
    seg_t, peq_t = torch.from_numpy(seg_T), torch.from_numpy(peq_pm)
    got = mc.match_full_dynls_ref(seg_t, peq_t, torch.from_numpy(ml), m)
    np.testing.assert_array_equal(got.numpy(), want)
    # the bound is exact: same rows as the unbounded sweep
    np.testing.assert_array_equal(got.numpy(), mc.match_full_ref(seg_t, peq_t, m).numpy())


def test_wrappers_take_plain_version_on_cpu():
    seg_T, peq_pm, lens = _case(16, 24, ragged=False, seed=7)
    seg_t, peq_t = torch.from_numpy(seg_T), torch.from_numpy(peq_pm)
    ml = torch.full((1, seg_T.shape[1] // mc.DEF_BR), 24, dtype=torch.int32)
    before = mc.LAUNCHES
    a = mc.match_full(seg_t, peq_t, 16)
    b = mc.match_full_dynls(seg_t, peq_t, ml, 16)
    assert mc.LAUNCHES == before  # no kernel launched for CPU tensors
    ref = mc.match_full_ref(seg_t, peq_t, 16)
    assert torch.equal(a, ref) and torch.equal(b, ref)


def test_cuda_without_a_card_raises():
    """No silent fallback: a CUDA request on a machine without one raises,
    and a tensor on any device but cpu/cuda is refused by the wrapper."""
    from sctagger_tpu_torch.models.matcher import match_segments

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        match_segments(["ACGTACGTACGTACGTAA"], ["ACGTACGTACGTACGT"], 1, device="cuda")
    meta = torch.empty((24, 1024), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no match kernel"):
        mc.match_full(meta, torch.empty((256, 8), dtype=torch.int32, device="meta"), 16)
