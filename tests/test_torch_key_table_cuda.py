"""The alt stage's key table built on the card (ops/exact_lookup.py
build_key_table), from a list of words and from the whitelist's one buffer,
against the same build on the CPU, and the device probe
handed the table on the card or on the CPU. Needs a CUDA device: skips
without one. tests/conftest.py imports JAX, which the card's machine lacks,
so run these there without it:

    python -m pytest --noconftest -m card tests/test_torch_key_table_cuda.py
"""

import gzip

import numpy as np
import pytest
import torch

import sctagger_tpu_torch.ops.exact_lookup as txl
from sctagger_tpu_torch.core.packing import rev_compl
from sctagger_tpu_torch.io.whitelist import read_whitelist

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, n: int, k: int) -> list[str]:
    raw = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, k))].tobytes()
    s = raw.decode("latin-1")
    return [s[i * k:(i + 1) * k] for i in range(n)]


def _whitelist(rng, n: int = 200_000) -> list[str]:
    """Random 16-mers with planted overlaps: 1,000 rc pairs, 1,000
    palindromes and 1,000 repeats, spread over the list."""
    wl = _words(rng, n, 16)
    halves = _words(rng, 1000, 8)
    for j in range(1000):
        wl[50_000 + j] = rev_compl(wl[j])
        wl[100_000 + j] = halves[j] + rev_compl(halves[j])
        wl[150_000 + j] = wl[10_000 + j]
    return wl


def test_key_table_on_the_card_equals_the_cpu_build(card):
    wl = _whitelist(np.random.default_rng(1))
    want_k, want_v = txl.build_key_table(wl)
    for rc in (None, [rev_compl(w) for w in wl]):
        got_k, got_v = txl.build_key_table(wl, rc, device=card)
        assert got_k.device.type == got_v.device.type == card.type
        assert torch.equal(got_k.cpu(), want_k) and torch.equal(got_v.cpu(), want_v)
    # the rc pairs and repeats replace two entries each, the palindromes one
    distinct = set(wl) | {rev_compl(w) for w in wl}
    assert want_k.numel() == len(distinct) <= 2 * len(wl) - 5000


def test_key_table_on_the_card_from_the_whitelist_buffer(card, tmp_path):
    """The whitelist file read as one buffer (io/whitelist.py) and uploaded
    as it is, against the CPU build from the list of its words."""
    wl = _whitelist(np.random.default_rng(3))
    path = tmp_path / "wl.txt.gz"
    path.write_bytes(gzip.compress("".join(w + "\n" for w in wl).encode(), 1))
    words = read_whitelist(str(path))
    assert words is not None and len(words) == len(wl) and words.k == 16
    got_k, got_v = txl.build_key_table(words, device=card)
    want_k, want_v = txl.build_key_table(wl)
    assert got_k.device.type == card.type
    assert torch.equal(got_k.cpu(), want_k) and torch.equal(got_v.cpu(), want_v)


def test_device_probe_takes_the_table_on_any_device(card, monkeypatch):
    rng = np.random.default_rng(2)
    wl = _whitelist(rng)
    segs = []
    for i in range(20_000):
        s = _words(rng, 1, 24)[0]
        for _ in range(int(rng.integers(0, 3))):  # 0-2 planted hits
            b = wl[int(rng.integers(len(wl)))]
            b = rev_compl(b) if rng.random() < 0.5 else b
            p = int(rng.integers(0, 9))
            s = s[:p] + b + s[p + 16:]
        if i % 97 == 0:  # junk rows go to the host probe
            s = s[:3] + "N" + s[4:]
        segs.append(s)
    on_card = txl.build_key_table(wl, device=card)
    on_cpu = txl.build_key_table(wl)
    monkeypatch.delenv("SCTAG_VIRTUAL_DEVICES", raising=False)
    a = txl.probe_segments(segs, *on_card, 16, device=card)  # the card: device probe
    b = txl._probe_segments_device(segs, *on_cpu, 16, txl.PROBE_CHUNK, card)
    h = txl.probe_segments(segs, *on_cpu, 16, device="cpu")  # one CPU: host probe
    for x, y, z in zip(a, b, h):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert (a[0] == 1).any() and (a[0] > 1).any()
