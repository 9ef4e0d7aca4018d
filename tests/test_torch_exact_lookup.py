"""The alt stage's whitelist lookup (sctagger_tpu_torch/ops/exact_lookup.py)
against sctagger_tpu/ops/exact_lookup.py on the same numpy-seeded inputs
(CPU). Tolerance: exact equality of keys, values and per-row (count,
single value)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sctagger_tpu.ops.exact_lookup as jxl
import sctagger_tpu_torch.ops.exact_lookup as txl
from sctagger_tpu.core.packing import STRICT_TABLE, rev_compl

torch.set_num_threads(1)


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _whitelist(rng, k: int, n: int = 60) -> list[str]:
    """Random barcodes plus two palindromes (their own reverse complement)
    and a pair that are each other's reverse complement."""
    wl = [_dna(rng, k) for _ in range(n)]
    half = _dna(rng, k // 2)
    wl.insert(5, half + rev_compl(half))  # palindrome: keep-last gives -5
    other = _dna(rng, k // 2)
    wl.append(other + rev_compl(other))
    wl.insert(20, rev_compl(wl[10]))
    return wl


def _segments(rng, wl: list[str], k: int, n: int = 400) -> list[str]:
    """Segments with 0, 1 and 2 planted hits (fwd or rc), some shorter than
    k, some with N inside."""
    segs = []
    for i in range(n):
        r = rng.random()
        if r < 0.1:
            segs.append(_dna(rng, int(rng.integers(0, k))))  # shorter than k
            continue
        s = _dna(rng, int(rng.integers(k, k + 30)))
        for _ in range(int(rng.integers(0, 3))):  # 0-2 planted hits
            b = wl[int(rng.integers(len(wl)))]
            if rng.random() < 0.5:
                b = rev_compl(b)
            p = int(rng.integers(0, len(s) - k + 1))
            s = s[:p] + b + s[p + k:]
        if rng.random() < 0.1:
            p = int(rng.integers(len(s)))
            s = s[:p] + "N" + s[p + 1:]
        segs.append(s)
    return segs


@pytest.mark.parametrize("k", [12, 16])
def test_key_table_and_revcomp_keys(k):
    rng = np.random.default_rng(k)
    wl = _whitelist(rng, k)
    got_k, got_v = txl.build_key_table(wl)
    want_k, want_v = jxl.build_key_table(wl)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_v, want_v)
    assert got_k.dtype == want_k.dtype and got_v.dtype == want_v.dtype
    # the palindromes and the rc pair keep their LAST value (-i)
    v = dict(zip(got_k.tolist(), got_v.tolist()))
    assert v[int(txl.build_key_table([wl[5]])[0][0])] == -5
    keys = jxl.build_key_table(wl)[0]
    np.testing.assert_array_equal(txl._revcomp_keys(keys, k), jxl._revcomp_keys(keys, k))
    # the explicit rc-strings form agrees with the numeric one
    for a, b in zip(txl.build_key_table(wl, [rev_compl(w) for w in wl]), (got_k, got_v)):
        np.testing.assert_array_equal(a, b)


def _packed(segs, k):
    L = -(-max(max(map(len, segs)), k) // 4) * 4
    codes, lens = jxl.encode_rows(segs, np.arange(len(segs)), pad_to=L,
                                  table=STRICT_TABLE)
    in_len = np.arange(L)[None, :] < lens[:, None]
    junk = ((codes > 3) & in_len).any(axis=1)
    c4 = (codes & 3).astype(np.uint8).reshape(len(segs), L // 4, 4)
    pk = c4[:, :, 0] | (c4[:, :, 1] << 2) | (c4[:, :, 2] << 4) | (c4[:, :, 3] << 6)
    return pk, np.where(junk, 0, lens).astype(np.int32), junk, L


@pytest.mark.parametrize("k", [12, 16])
def test_device_probe_equals_jax_probe_rows_packed(k):
    """probe_rows_packed == JAX _probe_rows_packed, called directly, on the
    same packed rows (segments shorter than k, junk rows at length 0, rows
    with more than one hit)."""
    rng = np.random.default_rng(100 + k)
    wl = _whitelist(rng, k)
    segs = _segments(rng, wl, k)
    sk, vv = jxl.build_key_table(wl)
    pk, lens, junk, L = _packed(segs, k)
    jc, jv = jxl._probe_rows_packed(
        jnp.asarray(sk), jnp.asarray(vv.astype(np.int32)), jnp.asarray(pk),
        jnp.asarray(lens), k, L,
    )
    tc, tv = txl.probe_rows_packed(
        torch.from_numpy(sk.astype(np.int64)), torch.from_numpy(vv),
        torch.from_numpy(pk), torch.from_numpy(lens), k, L,
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert junk.any() and (tc.numpy() > 1).any() and (tc.numpy() == 1).any()
    assert any(len(s) < k for s in segs)


@pytest.mark.parametrize("k", [12, 16])
def test_probe_segments_host_equals_device(k, monkeypatch):
    rng = np.random.default_rng(200 + k)
    wl = _whitelist(rng, k)
    segs = _segments(rng, wl, k, n=700)
    sk, vv = txl.build_key_table(wl)
    want = jxl._probe_rows_host(segs, *jxl.build_key_table(wl), k)
    monkeypatch.setenv("SCTAG_PROBE", "host")
    host = txl.probe_segments(segs, sk, vv, k)
    monkeypatch.setenv("SCTAG_PROBE", "device")
    dev = txl.probe_segments(segs, sk, vv, k, chunk=128, device="cpu")
    for a, b, c in zip(host, dev, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert (host[0] > 1).any() and (host[0] == 1).any()


def test_probe_segments_device_on_a_seqbuffer(tmp_path, monkeypatch):
    """The device probe on the LR reader's SeqBuffer (native 2-bit pack,
    junk flags) == the host probe on the same rows."""
    from sctagger_tpu_torch.io.tsv import read_lr_segments_tsv

    rng = np.random.default_rng(7)
    wl = _whitelist(rng, 16)
    segs = _segments(rng, wl, 16, n=300)
    lr = tmp_path / "lr.tsv"
    lr.write_text("".join(f"r{i}\t1\t5\t{s}\n" for i, s in enumerate(segs)))
    buf = read_lr_segments_tsv(str(lr))[3]
    assert hasattr(buf, "encode_packed")
    sk, vv = txl.build_key_table(wl)
    monkeypatch.setenv("SCTAG_PROBE", "device")
    got = txl.probe_segments(buf, sk, vv, 16, chunk=64, device="cpu")
    want = jxl._probe_rows_host(segs, sk, vv, 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("words", [
    ["ACGTACGT", "ACGTACGTACGTAC", "AC"],  # ragged (lengths sum to 3 x 8)
    ["ACGTACGTACGTACGT", "ACGTNCGTACGTACGT", "TTTTACGTACGTACGA"],  # non-ACGT
], ids=["ragged", "non_acgt"])
def test_exotic_whitelists_go_to_host_dict_fallback(words):
    with pytest.raises(ValueError):
        txl.build_key_table(words)
    with pytest.raises(ValueError):
        jxl.build_key_table(words)
    rng = np.random.default_rng(3)
    segs = [_dna(rng, 6) + w + _dna(rng, 3) for w in words] + [_dna(rng, 30)]
    rc = [rev_compl(w) for w in words]
    for a, b in zip(txl.host_dict_fallback(segs, words, rc),
                    jxl.host_dict_fallback(segs, words, rc)):
        np.testing.assert_array_equal(a, b)


def test_failing_host_probe_raises(monkeypatch):
    """No hidden fallback: a host probe that fails raises, in the host probe
    and in the device probe's junk-row re-probe, and never moves to the
    device."""
    from sctagger_tpu_torch.native import build as native_build

    rng = np.random.default_rng(11)
    wl = _whitelist(rng, 16, n=10)
    sk, vv = txl.build_key_table(wl)
    segs = [_dna(rng, 30), "ACGTN" + wl[0]]

    def _no_lib():
        raise OSError("native library unavailable")

    def _no_device(*a, **k):
        raise AssertionError("moved to the device probe")

    monkeypatch.setattr(native_build, "load", _no_lib)
    monkeypatch.setattr(txl, "_probe_segments_device", _no_device)
    monkeypatch.setenv("SCTAG_PROBE", "host")
    with pytest.raises(OSError, match="unavailable"):
        txl.probe_segments(segs, sk, vv, 16)
    monkeypatch.undo()
    monkeypatch.setattr(native_build, "load", _no_lib)
    monkeypatch.setenv("SCTAG_PROBE", "device")
    with pytest.raises(OSError, match="unavailable"):
        txl.probe_segments(segs, sk, vv, 16, device="cpu")
    monkeypatch.setenv("SCTAG_PROBE", "gpu")
    with pytest.raises(ValueError, match="SCTAG_PROBE"):
        txl.probe_segments(segs, sk, vv, 16, device="cpu")
