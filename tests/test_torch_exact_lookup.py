"""The alt stage's whitelist lookup (sctagger_tpu_torch/ops/exact_lookup.py)
against sctagger_tpu/ops/exact_lookup.py on the same numpy-seeded inputs
(CPU). Tolerance: exact equality of keys, values and per-row (count,
single value). The port's key table is int64 tensors holding the values of
the JAX package's (uint32 keys, int64 values)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sctagger_tpu.ops.exact_lookup as jxl
import sctagger_tpu_torch.ops.exact_lookup as txl
from sctagger_tpu.core.packing import STRICT_TABLE, rev_compl
from sctagger_tpu_torch.observability import stage_scope

torch.set_num_threads(1)


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _whitelist(rng, k: int, n: int = 60) -> list[str]:
    """Random barcodes plus two palindromes (their own reverse complement),
    a pair that are each other's reverse complement and, last, a repeat of
    word n // 2."""
    wl = [_dna(rng, k) for _ in range(n)]
    half = _dna(rng, k // 2)
    wl.insert(5, half + rev_compl(half))  # palindrome: keep-last gives -5
    other = _dna(rng, k // 2)
    wl.append(other + rev_compl(other))
    wl.insert(20, rev_compl(wl[10]))  # word 10's key keeps -20
    wl.append(wl[n // 2])  # a repeat: its key keeps the later index
    return wl


def _key(word: str) -> int:
    return int(word.translate(str.maketrans("ACGT", "0123")), 4)


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


@pytest.mark.parametrize("form", ["numeric_rc", "words_rc"])
@pytest.mark.parametrize("k", [8, 12, 16])
def test_key_table_and_revcomp_keys(k, form):
    """The torch build (CPU) == the JAX package's, value for value, with rc
    keys packed beside the fwd ones or from explicit rc words."""
    rng = np.random.default_rng(k)
    wl = _whitelist(rng, k)
    rc = None if form == "numeric_rc" else [rev_compl(w) for w in wl]
    got_k, got_v = txl.build_key_table(wl, rc)
    want_k, want_v = jxl.build_key_table(wl, rc)
    assert got_k.dtype == torch.int64 and got_v.dtype == torch.int64
    assert want_k.dtype == np.uint32 and want_v.dtype == np.int64
    np.testing.assert_array_equal(got_k.numpy(), want_k.astype(np.int64))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    # keep-LAST: the palindrome and the rc pair keep -i, the repeat its
    # later index (fwd and rc)
    v = dict(zip(got_k.tolist(), got_v.tolist()))
    assert v[_key(wl[5])] == -5 and v[_key(wl[10])] == -20
    assert v[_key(wl[30])] == len(wl) - 1
    assert v[_key(rev_compl(wl[30]))] == -(len(wl) - 1)
    # the numeric and the explicit rc forms agree
    for a, b in zip(txl.build_key_table(wl, [rev_compl(w) for w in wl]),
                    txl.build_key_table(wl)):
        assert torch.equal(a, b)


def test_key_table_spans_and_counters():
    """The build's spans and counters: entries kept, entries a later add
    replaced (fwd/rc overlaps and repeats), and where it was built."""
    rng = np.random.default_rng(5)
    wl = _whitelist(rng, 16)
    with stage_scope("t") as st:
        keys, _ = txl.build_key_table(wl)
    assert st.counters["key_table.entries"] == keys.numel()
    # palindromes 2, the rc pair 2, the repeat's fwd and rc 2
    assert st.counters["key_table.overwritten"] == 2 * len(wl) - keys.numel() == 6
    assert st.counters["key_table.on_device"] == 0
    assert {"key_table.encode", "key_table.build"} <= set(st.timers)


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


@pytest.mark.parametrize("k", [8, 12, 16])
def test_probe_segments_host_equals_device(k):
    rng = np.random.default_rng(200 + k)
    wl = _whitelist(rng, k)
    segs = _segments(rng, wl, k, n=700)
    sk, vv = txl.build_key_table(wl)
    want = jxl._probe_rows_host(segs, *jxl.build_key_table(wl), k)
    host = txl._probe_rows_host(segs, sk, vv, k)
    dev = txl._probe_segments_device(segs, sk, vv, k, 128, torch.device("cpu"))
    for a, b, c in zip(host, dev, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert (host[0] > 1).any() and (host[0] == 1).any()


def test_probe_segments_device_on_a_seqbuffer(tmp_path):
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
    got = txl._probe_segments_device(buf, sk, vv, 16, 64, torch.device("cpu"))
    want = jxl._probe_rows_host(segs, *jxl.build_key_table(wl), 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("words", [
    ["ACGTACGT", "ACGTACGTACGTAC", "AC"],  # ragged (lengths sum to 3 x 8)
    ["ACGTACGTACGTACGT", "ACGTNCGTACGTACGT", "TTTTACGTACGTACGA"],  # non-ACGT
    ["ACGTACGTACGTACGTA", "TTTTACGTACGTACGAC"],  # k = 17
    [],
    ["ACGTACGT", "ACGT\u00c4CGT"],  # one byte in latin-1, not ACGT
    ["ACGTACGT", "ACGT\u03a9CGT"],  # not latin-1
    ["ACGTACGT", "ACG\nACGT", "TTTTACGT"],  # a newline inside a word
    ["ACGTACGT", "acgtacgt"],  # lower case
], ids=["ragged", "non_acgt", "overlong", "empty", "latin1", "non_latin1",
        "newline", "lower_case"])
def test_exotic_whitelists_go_to_host_dict_fallback(words):
    rc = [w[::-1].translate(str.maketrans("ACGT", "TGCA")) for w in words]
    for words_rc in (None, rc):
        with pytest.raises(ValueError):
            txl.build_key_table(words, words_rc)
        with pytest.raises(ValueError):
            jxl.build_key_table(words, words_rc)
    rng = np.random.default_rng(3)
    segs = [_dna(rng, 6) + w + _dna(rng, 3) for w in words] + [_dna(rng, 30)]
    for a, b in zip(txl.host_dict_fallback(segs, words, rc),
                    jxl.host_dict_fallback(segs, words, rc)):
        np.testing.assert_array_equal(a, b)


def test_failing_host_probe_raises(monkeypatch):
    """No hidden fallback: a host probe that fails raises, in the host probe
    and in the device probe's junk-row re-probe, and never moves to the
    device. The probe follows the device: the host probe on one CPU device,
    the device probe on a grid of two."""
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
    monkeypatch.delenv("SCTAG_VIRTUAL_DEVICES", raising=False)
    with pytest.raises(OSError, match="unavailable"):
        txl.probe_segments(segs, sk, vv, 16, device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(native_build, "load", _no_lib)
    with pytest.raises(OSError, match="unavailable"):
        txl._probe_segments_device(segs, sk, vv, 16, 64, torch.device("cpu"))

    # the device follows the grid: with two devices the device probe runs
    seen = []
    real = txl._probe_segments_device
    monkeypatch.setattr(txl, "_probe_segments_device",
                        lambda *a: seen.append(a[-1]) or real(*a))
    monkeypatch.setenv("SCTAG_VIRTUAL_DEVICES", "2")
    with pytest.raises(OSError, match="unavailable"):  # the junk row's re-probe
        txl.probe_segments(segs, sk, vv, 16, device="cpu")
    assert seen == [torch.device("cpu")]
