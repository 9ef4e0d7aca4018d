"""The port's in-process device grid (sctagger_tpu_torch/parallel/mesh.py;
twin of test_parallel.py). On the CPU, SCTAG_VIRTUAL_DEVICES repeats the
CPU device, so a grid of data 1/2/4 x model 1/2 runs every split and merge.
Each shard_* function must equal its one-device twin exactly, and the JAX
package's shard_* output on its 8-device CPU mesh on the same numpy-seeded
inputs. Tolerance: exact equality (all values are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctagger_tpu.ops.exact_lookup as jxl
import sctagger_tpu.parallel as jpar
import sctagger_tpu_torch.ops.exact_lookup as txl
from oracle import random_dna
from sctagger_tpu.core.packing import (
    LENIENT_TABLE,
    STRICT_TABLE,
    encode_seqs,
    encode_str,
    pack_kmers_from_codes,
    rev_compl,
)
from sctagger_tpu.ops.myers import build_peq_multi, build_peq_multi_mw
from sctagger_tpu_torch.ops import adapter_cuda as ac
from sctagger_tpu_torch.ops import match_cuda as mc
from sctagger_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

GRIDS = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (4, 2)]  # (data, model)
ADAPTER = "CTACACGACGCTCTTCCGATCT"
BR, BP = 128, 8


@pytest.fixture(autouse=True)
def _eight_cpu_devices(monkeypatch):
    monkeypatch.setenv("SCTAG_VIRTUAL_DEVICES", "8")
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    for k in ("SCTAG_MAX_DEVICES", "SCTAG_MODEL_PARALLEL"):
        monkeypatch.delenv(k, raising=False)


def _grid(dp, mp):
    return pm.make_mesh(dp * mp, model_parallel=mp, device="cpu")


def _match_problem():
    """4 * 128 - 7 reads of 24 bp with exact planted hits against 64
    patterns made of 12 barcodes cycled, so tie sets cross every
    model-axis split and overflow TIES_K."""
    rng = np.random.default_rng(7)
    base = [random_dna(rng, 16) for _ in range(12)]
    barcodes = [base[i % len(base)] for i in range(64)]
    n = 4 * BR - 7
    segs = [random_dna(rng, 24) for _ in range(n)]
    for r in range(0, n, 2):
        segs[r] = segs[r][:4] + barcodes[r % len(barcodes)] + segs[r][4:]
    seg_codes, _ = encode_seqs(segs, pad_to=48, table=LENIENT_TABLE)
    peq = build_peq_multi(encode_seqs(barcodes, pad_to=16, table=LENIENT_TABLE)[0])
    return seg_codes, peq


def test_local_mesh_divisor_cap_and_virtual(monkeypatch):
    """local_mesh as the JAX one: the largest data size dividing the block
    count wins; SCTAG_MAX_DEVICES caps; SCTAG_MODEL_PARALLEL splits."""
    mesh = pm.local_mesh(device="cpu")
    assert mesh is not None and mesh.size == 8 and mesh.shape == {"data": 8, "model": 1}
    assert pm.local_mesh(divisor=12, device="cpu").shape["data"] == 6
    assert pm.local_mesh(divisor=7, device="cpu").shape["data"] == 7
    assert pm.local_mesh(divisor=1, device="cpu") is None
    monkeypatch.setenv("SCTAG_MAX_DEVICES", "1")
    assert pm.local_mesh(device="cpu") is None
    monkeypatch.setenv("SCTAG_MAX_DEVICES", "4")
    assert pm.local_mesh(device="cpu").size == 4
    monkeypatch.setenv("SCTAG_MODEL_PARALLEL", "2")
    assert pm.local_mesh(device="cpu").shape == {"data": 2, "model": 2}
    monkeypatch.delenv("SCTAG_VIRTUAL_DEVICES")
    monkeypatch.delenv("SCTAG_MAX_DEVICES")
    assert pm.compute_devices("cpu") == [torch.device("cpu")]
    assert pm.local_mesh(device="cpu") is None  # one CPU device, no grid


def test_shard_match_full_and_mp_match_single_device_and_jax():
    from sctagger_tpu.ops.match_pallas import match_full_tpu
    from sctagger_tpu.ops.match_pallas import prep_peq_cols as j_peq_cols
    from sctagger_tpu.ops.match_pallas import prep_segs_T as j_segs_T

    seg_codes, peq = _match_problem()
    seg_T = torch.from_numpy(mc.prep_segs_T(seg_codes, ls=48, br=4 * BR))
    peq_pm = torch.from_numpy(mc.prep_peq_cols(peq, bp=BP))
    assert peq_pm.shape[0] == 64
    single = mc.match_full(seg_T, peq_pm, 16)
    assert (single[1] > mc.TIES_K).any()  # overflow rows are exercised
    jseg = jnp.asarray(j_segs_T(seg_codes, ls=48, br=BR, r_pad=4 * BR))
    jpeq = jnp.asarray(j_peq_cols(peq, bp=BP))
    want = np.asarray(jpar.shard_match_full_mp(
        jpar.make_mesh(8, model_parallel=2), jseg, jpeq, 16, br=BR, bp=BP,
        interpret=True))
    np.testing.assert_array_equal(want, np.asarray(
        match_full_tpu(jseg, jpeq, 16, br=BR, bp=BP, interpret=True)))
    np.testing.assert_array_equal(single.numpy(), want)
    for dp, mp in GRIDS:
        mesh = _grid(dp, mp)
        pm.STATS.update(sharded_calls=0, devices=0)
        if mp == 1:
            got = pm.shard_match_full(mesh, seg_T, peq_pm, 16, br=BR)
        else:
            got = pm.shard_match_full_mp(mesh, seg_T, peq_pm, 16, br=BR, bp=BP)
        assert pm.STATS == {"sharded_calls": 1, "devices": dp * mp}
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{dp}x{mp}")


def test_shard_match_full_maxlens_travels_with_its_slice():
    """K2's per-block sweep bound rides with each data slice: the grid
    output equals match_full_dynls on one device and match_full."""
    rng = np.random.default_rng(3)
    seg_codes, peq = _match_problem()
    lens = rng.integers(16, 49, size=seg_codes.shape[0])
    lens.sort()
    for i, n in enumerate(lens):
        seg_codes[i, n:] = 4
    seg_T = torch.from_numpy(mc.prep_segs_T(seg_codes, ls=48, br=4 * BR))
    ml = np.zeros(seg_T.shape[1], np.int32)
    ml[: lens.size] = lens
    ml = torch.from_numpy(ml.reshape(1, -1, BR).max(axis=2))
    peq_pm = torch.from_numpy(mc.prep_peq_cols(peq, bp=BP))
    want = mc.match_full(seg_T, peq_pm, 16)
    assert torch.equal(mc.match_full_dynls(seg_T, peq_pm, ml, 16), want)
    for dp, mp in GRIDS:
        got = pm.shard_match_full_mp(_grid(dp, mp), seg_T, peq_pm, 16, br=BR, bp=BP,
                                     maxlens=ml)
        assert torch.equal(got, want), (dp, mp)


def test_shard_match_min_matches_single_device_and_jax():
    seg_codes, peq = _match_problem()
    n = seg_codes.shape[0]
    seg_T = torch.from_numpy(mc.prep_segs_T(seg_codes, ls=48, br=4 * BR))
    peq_pm = torch.from_numpy(mc.prep_peq_cols(peq, bp=BP))
    single = mc.match_min(seg_T, peq_pm, 16)
    jseg = np.zeros((48, 4 * BR), np.int32)
    jseg[:] = 4
    jseg[:, :n] = seg_codes.T
    want = np.asarray(jpar.shard_match_min(jpar.make_mesh(8, model_parallel=2),
                                           jnp.asarray(jseg), jnp.asarray(peq), 16))
    np.testing.assert_array_equal(single.numpy()[0], want)
    for dp, mp in GRIDS:
        got = pm.shard_match_min(_grid(dp, mp), seg_T, peq_pm, 16, bp=BP)
        np.testing.assert_array_equal(got.numpy()[0], want, err_msg=f"{dp}x{mp}")


def _adapter_reads(rng, n):
    reads = []
    for _ in range(n):
        body = random_dna(rng, int(rng.integers(0, 90)))
        if rng.random() < 0.5 and body:
            p = int(rng.integers(0, len(body)))
            a = ADAPTER if rng.random() < 0.5 else rev_compl(ADAPTER)
            body = body[:p] + a + body[p:]
        reads.append(body)
    reads.append("CC" + (ADAPTER + "TTT") * 6)  # > 4 optimal ends
    return reads


def test_shard_adapter_scan_matches_single_device_and_jax():
    from sctagger_tpu.ops.adapter_pallas import (
        BLOCK_READS,
        adapter_scan_dispatch,
        unpack_scan_out,
    )

    rng = np.random.default_rng(5)
    reads = _adapter_reads(rng, 2 * BLOCK_READS - 14)
    n = len(reads)
    peq2 = build_peq_multi(np.stack([encode_str(ADAPTER), encode_str(rev_compl(ADAPTER))]))
    codes, lens = encode_seqs(reads, pad_to=max(map(len, reads)))
    jout = adapter_scan_dispatch(codes, lens.astype(np.int32), peq2, len(ADAPTER),
                                 interpret=True, b_pad=2 * BLOCK_READS,
                                 mesh=jpar.make_mesh(2, model_parallel=1))
    jfwd, jrc = unpack_scan_out(np.asarray(jout), n)
    text, ln, junk = ac.pack_chunk(reads, np.arange(n), max(map(len, reads)))
    assert not junk.any()
    args = (torch.from_numpy(text), torch.from_numpy(ln), ac.prep_peq(peq2), len(ADAPTER))
    single = ac.adapter_scan(*args)
    over = 0
    for dp in (1, 2, 4):
        got = pm.shard_adapter_scan(_grid(dp, 1), *args)
        assert torch.equal(got, single), dp
        for want, have in zip((jfwd, jrc), ac.unpack_scan_out(got.numpy(), n)):
            np.testing.assert_array_equal(have["d"], want["d"])
            np.testing.assert_array_equal(np.minimum(have["cnt"], 255),
                                          np.minimum(want["cnt"], 255))
            filled = np.arange(ac.SLOTS_K)[None, :] < np.minimum(
                have["cnt"], ac.SLOTS_K)[:, None]
            np.testing.assert_array_equal(have["slots"][filled], want["slots"][filled])
            over += int((have["cnt"] > ac.SLOTS_K).sum())
    assert over > 0


@pytest.mark.parametrize("adapter", [ADAPTER, ADAPTER + "AGTCAGGTACGTAGGCATG"],
                         ids=["m22", "m41_multiword"])
def test_shard_hw_block_matches_single_device_and_jax(adapter):
    """The mask fallback over the grid: K6 MASK's plain version at m <= 32,
    the multi-word hw_block above; (d, mask bits) == one device == the JAX
    shard_hw_block's (d, mask) on a 2-device mesh."""
    from sctagger_tpu_torch.ops.myers import MAX_PATTERN_LEN

    m = len(adapter)
    rng = np.random.default_rng(6)
    reads = [r[:40] + "N" + r[41:] if i % 7 == 0 and len(r) > 41 else r
             for i, r in enumerate(_adapter_reads(rng, 63))]
    pat = np.stack([encode_str(adapter), encode_str(rev_compl(adapter))])
    peq2 = build_peq_multi(pat) if m <= MAX_PATTERN_LEN else build_peq_multi_mw(pat)
    L = -(-max(map(len, reads)) // 32) * 32
    codes, lens = encode_seqs(reads, pad_to=L, table=STRICT_TABLE)
    jd, jmask = jpar.shard_hw_block(jpar.make_mesh(2, model_parallel=1),
                                    jnp.asarray(codes.astype(np.int32).T),
                                    jnp.asarray(peq2), jnp.asarray(lens.astype(np.int32)), m)
    want_bits = ac.pack_mask_bits(torch.from_numpy(np.array(jmask)))
    c, ln = torch.from_numpy(codes), torch.from_numpy(lens.astype(np.int32))
    one_d, one_bits = pm.shard_hw_block(_grid(1, 1), c, ln, peq2, m)
    np.testing.assert_array_equal(one_d.numpy(), np.asarray(jd))
    assert torch.equal(one_bits, want_bits)
    for dp in (2, 4):
        d, bits = pm.shard_hw_block(_grid(dp, 1), c, ln, peq2, m)
        assert torch.equal(d, one_d) and torch.equal(bits, one_bits), dp


def test_shard_probe_matches_single_device_and_jax():
    """The device probe over the grid (table replicated once per device) ==
    probe_rows_packed on one device == the JAX shard_probe on its 8-device
    mesh (rows padded there with invalid windows)."""
    k = 16
    rng = np.random.default_rng(9)
    wl = [random_dna(rng, k) for _ in range(50)]
    segs = []
    for i in range(203):
        s = random_dna(rng, int(rng.integers(0, 6)))
        for _ in range(int(rng.integers(0, 3))):  # 0-2 hits, apart
            b = wl[int(rng.integers(len(wl)))]
            s += (rev_compl(b) if rng.random() < 0.5 else b) + random_dna(rng, 3)
        segs.append(s + random_dna(rng, k))
    sk, vv = jxl.build_key_table(wl)
    L = -(-max(map(len, segs)) // 4) * 4
    codes, lens = encode_seqs(segs, pad_to=L, table=STRICT_TABLE)
    c4 = (codes & 3).astype(np.uint8).reshape(len(segs), L // 4, 4)
    pk = c4[:, :, 0] | (c4[:, :, 1] << 2) | (c4[:, :, 2] << 4) | (c4[:, :, 3] << 6)
    qk, qv = pack_kmers_from_codes(codes, lens, k)
    rows = -(-len(segs) // 8) * 8
    qk = np.pad(qk.view(np.uint32), ((0, rows - len(segs)), (0, 0)))
    qv = np.pad(qv, ((0, rows - len(segs)), (0, 0)))
    hit, val = jpar.mesh.shard_probe(jpar.make_mesh(8, model_parallel=1),
                                     jnp.asarray(sk), jnp.asarray(vv.astype(np.int32)),
                                     jnp.asarray(qk), jnp.asarray(qv))
    hit, val = np.asarray(hit)[: len(segs)], np.asarray(val)[: len(segs)].astype(np.int64)
    want_c = hit.sum(axis=1)
    want_v = np.where(want_c == 1, (val * hit).sum(axis=1), 0)
    sk_t, vv_t = torch.from_numpy(sk.astype(np.int64)), torch.from_numpy(vv)
    pk_t, ln_t = torch.from_numpy(pk), torch.from_numpy(lens.astype(np.int32))
    one = txl.probe_rows_packed(sk_t, vv_t, pk_t, ln_t, k, L)
    np.testing.assert_array_equal(one[0].numpy(), want_c)
    np.testing.assert_array_equal(one[1].numpy(), want_v)
    assert (want_c == 1).any() and (want_c > 1).any()
    for dp in (1, 2, 4):
        mesh = _grid(dp, 1)
        got = pm.shard_probe(mesh, pm.replicate(mesh, sk_t, vv_t), pk_t, ln_t, k, L)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]), dp


def test_stages_engage_the_grid(monkeypatch):
    """match_segments, scan_adapters_stream (kernel chunks and the mask
    fallback) and the probe go through the grid when several devices are
    visible, with the same results as on one device (where the probe is the
    host probe)."""
    from sctagger_tpu_torch.models.adapter import scan_adapters_stream
    from sctagger_tpu_torch.models.matcher import match_segments

    rng = np.random.default_rng(12)
    bcs = [random_dna(rng, 16) for _ in range(40)]
    segs = [random_dna(rng, 10) + bcs[i % 40][:7] + "A" + bcs[i % 40][8:] + random_dna(rng, 5)
            for i in range(300)]
    reads = _adapter_reads(rng, 200)
    reads[3] = reads[3][:5] + "N" + reads[3][6:] if len(reads[3]) > 6 else "ACGTN" + ADAPTER
    sk, vv = txl.build_key_table(bcs)

    def _run():
        r = match_segments(segs, bcs, 2, device="cpu")
        s = scan_adapters_stream([((), reads)], ADAPTER, device="cpu")[2]
        p = txl.probe_segments(segs, sk, vv, 16, chunk=64, device="cpu")
        return ([r.rids.tolist(), r.dists.tolist(), [r.ties_of(i).tolist()
                 for i in range(r.rids.size)]],
                [s.strands.tolist(), s.dists.tolist(), s.flat_locs.tolist()],
                [p[0].tolist(), p[1].tolist()])

    monkeypatch.setenv("SCTAG_MAX_DEVICES", "1")
    want = _run()
    for n, mp in ((4, 1), (4, 2)):
        monkeypatch.setenv("SCTAG_MAX_DEVICES", str(n))
        monkeypatch.setenv("SCTAG_MODEL_PARALLEL", str(mp))
        pm.STATS.update(sharded_calls=0, devices=0)
        assert _run() == want, (n, mp)
        assert pm.STATS["sharded_calls"] >= 4 and pm.STATS["devices"] == 4
    assert len(want[0][0]) > 10
