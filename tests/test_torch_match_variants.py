"""The plain versions of the min, best-matrix and ties match kernels
(sctagger_tpu_torch.ops.match_cuda: match_min_ref, match_best_ref,
match_ties_ref) against the Pallas kernel bodies they port
(_match_min_kernel, _match_best_kernel, _match_ties_kernel), run in
interpret mode on the CPU through a local pallas_call harness.

Both packages pad patterns to a multiple of 256 with all-zero Peq rows, so
the full outputs are compared, padding included. Tolerance: exact equality
(all values are integers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs, rev_compl
from sctagger_tpu.ops import match_pallas as jp
from sctagger_tpu_torch.models.matcher import MatchContext
from sctagger_tpu_torch.ops import match_cuda as mc

torch.set_num_threads(1)

R = 1024 - 3  # one read block with padded read columns
N_BC = 300  # -> 600 patterns, not a multiple of the 256-pattern tile
BR, BP = 1024, 256

# (m, ls, ragged)
CASES = [(16, 24, False), (31, 40, True), (32, 40, False)]


def _pallas(kernel, seg_T, peq_pm, m, out_rows, out_dtype, target=None):
    """One Pallas match kernel in interpret mode: grid (reads, patterns);
    the best matrix is tiled over both axes, the row outputs over reads."""
    ls, r = seg_T.shape
    p = peq_pm.shape[0]
    in_specs = [
        pl.BlockSpec((ls, BR), lambda i, j: (0, i), memory_space=pltpu.VMEM),
        pl.BlockSpec((BP, 8), lambda i, j: (j, 0), memory_space=pltpu.VMEM),
    ]
    args = [jnp.asarray(seg_T), jnp.asarray(peq_pm)]
    if target is not None:
        in_specs.append(pl.BlockSpec((1, BR), lambda i, j: (0, i), memory_space=pltpu.VMEM))
        args.append(jnp.asarray(target.reshape(1, r)))
    if out_rows is None:  # the (P_pad, R_pad) best matrix
        out_spec = pl.BlockSpec((BP, BR), lambda i, j: (j, i), memory_space=pltpu.VMEM)
        shape = (p, r)
    else:
        out_spec = pl.BlockSpec((out_rows, BR), lambda i, j: (0, i), memory_space=pltpu.VMEM)
        shape = (out_rows, r)
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, m=m, ls=ls),
        grid=(r // BR, p // BP),
        in_specs=in_specs,
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct(shape, out_dtype),
        scratch_shapes=[pltpu.VMEM((ls, BR), jnp.int32)],
        interpret=True,
    )(*args))


@functools.lru_cache(maxsize=None)
def _case(m: int, ls: int, ragged: bool):
    """Reads with planted (mutated, possibly reverse-complement) barcodes;
    one barcode appears ten times in the whitelist, so reads carrying it
    have more than 8 ties. Returns numpy seg_T, peq_pm and the Pallas K1
    rows (whose row 0 is every read's min)."""
    rng = np.random.default_rng(1000 + m)
    alpha = np.array(list("ACGT"))
    core = "".join(rng.choice(alpha, m))
    bcs = [core] * 10 + ["".join(rng.choice(alpha, m)) for _ in range(N_BC - 10)]
    segs = []
    for i in range(R):
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
    codes, _ = encode_seqs(segs, pad_to=ls, table=LENIENT_TABLE)
    seg_T = mc.prep_segs_T(codes, ls)
    peq_pm = mc.prep_peq_cols(MatchContext(bcs).peq())
    full = np.asarray(jp.match_full_tpu(jnp.asarray(seg_T), jnp.asarray(peq_pm), m,
                                        interpret=True))
    return seg_T, peq_pm, full


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m,ls,ragged", CASES)
def test_match_min_ref_vs_pallas(m, ls, ragged):
    seg_T, peq_pm, full = _case(m, ls, ragged)
    want = _pallas(jp._match_min_kernel, seg_T, peq_pm, m, 1, jnp.int32)
    got = mc.match_min_ref(_t(seg_T), _t(peq_pm), m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[0], full[0])  # K4 is K1's row 0


@pytest.mark.parametrize("m,ls,ragged", CASES)
def test_match_best_ref_vs_pallas(m, ls, ragged):
    seg_T, peq_pm, _ = _case(m, ls, ragged)
    want = _pallas(jp._match_best_kernel, seg_T, peq_pm, m, None, jnp.int8)
    got = mc.match_best_ref(_t(seg_T), _t(peq_pm), m)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[600:] == m).all()  # padding patterns score m


@pytest.mark.parametrize("m,ls,ragged", CASES)
@pytest.mark.parametrize("at", ["min", "m"])
def test_match_ties_ref_vs_pallas(m, ls, ragged, at):
    """Hits at each read's min (K1's row 0: then K3 is K1's rows 1..) and at
    m, where the 168 all-zero padding patterns are hits of every read."""
    seg_T, peq_pm, full = _case(m, ls, ragged)
    target = full[0].copy() if at == "min" else np.full(seg_T.shape[1], m, np.int32)
    want = _pallas(jp._match_ties_kernel, seg_T, peq_pm, m, mc.TIES_K + 1, jnp.int32,
                   target=target)
    got = mc.match_ties_ref(_t(seg_T), _t(peq_pm), _t(target), m)
    np.testing.assert_array_equal(got.numpy(), want)
    if at == "min":
        np.testing.assert_array_equal(want, full[1:])
        assert (want[0, :R] > mc.TIES_K).any()  # slot overflow covered
    else:
        assert (want[0] >= peq_pm.shape[0] - 2 * N_BC).all()


def test_plain_tile_merge(monkeypatch):
    """The plain merge rule across pattern and read tiles: 16-pattern,
    256-read tiles (38 pattern tiles, reads in 4 tiles) give the rows of one
    tile. Hits past the slots of earlier tiles still add to the count, and
    the first 8 ids across tiles stay ascending."""
    seg_T, peq_pm, full = _case(16, 24, False)
    seg, peq = _t(seg_T), _t(peq_pm)
    target = _t(full[0].copy())
    one = (mc.match_min_ref(seg, peq, 16), mc.match_best_ref(seg, peq, 16),
           mc.match_ties_ref(seg, peq, target, 16), mc.match_full_ref(seg, peq, 16))
    monkeypatch.setattr(mc, "_P_TILE", 16)
    monkeypatch.setattr(mc, "_R_TILE", 256)
    tiled = (mc.match_min_ref(seg, peq, 16), mc.match_best_ref(seg, peq, 16),
             mc.match_ties_ref(seg, peq, target, 16), mc.match_full_ref(seg, peq, 16))
    for a, b in zip(one, tiled):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tiled[2].numpy(), full[1:])


def test_variant_wrappers_take_plain_version_on_cpu():
    seg_T, peq_pm, full = _case(16, 24, False)
    seg, peq = _t(seg_T), _t(peq_pm)
    target = _t(full[0].copy())
    before = (mc.MIN_LAUNCHES, mc.BEST_LAUNCHES, mc.TIES_LAUNCHES, mc.LAUNCHES)
    a = mc.match_min(seg, peq, 16)
    b = mc.match_best(seg, peq, 16)
    c = mc.match_ties(seg, peq, target, 16)
    assert (mc.MIN_LAUNCHES, mc.BEST_LAUNCHES, mc.TIES_LAUNCHES, mc.LAUNCHES) == before
    assert torch.equal(a, mc.match_min_ref(seg, peq, 16))
    assert torch.equal(b, mc.match_best_ref(seg, peq, 16))
    assert torch.equal(c, mc.match_ties_ref(seg, peq, target, 16))


def test_variant_wrappers_refuse_other_devices():
    seg = torch.empty((24, 1024), dtype=torch.int8, device="meta")
    peq = torch.empty((256, 8), dtype=torch.int32, device="meta")
    tgt = torch.empty((1024,), dtype=torch.int32, device="meta")
    for call in (lambda: mc.match_min(seg, peq, 16), lambda: mc.match_best(seg, peq, 16),
                 lambda: mc.match_ties(seg, peq, tgt, 16)):
        with pytest.raises(ValueError, match="no match kernel"):
            call()
