"""The alt stage's one-buffer whitelist read (sctagger_tpu_torch/io/whitelist.py
over native/gz_inflate.cpp) on the CPU: the inflate against Python's gzip
and plain reads; read_whitelist's words against the reference's line list;
and the key table built from the buffer against the one built from the
list."""

import gzip

import numpy as np
import pytest
import torch

from sctagger_tpu_torch.io import whitelist as twl
from sctagger_tpu_torch.ops.exact_lookup import build_key_table

torch.set_num_threads(1)


def _lines(rng, n: int, k: int) -> bytes:
    words = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, k))]
    return np.concatenate([words, np.full((n, 1), 10, np.uint8)], 1).tobytes()


def _members(data: bytes, size: int) -> bytes:
    return b"".join(gzip.compress(data[i:i + size], compresslevel=1)
                    for i in range(0, len(data), size))


# name -> (the file's bytes from the text, gz)
CASES = {
    "one_member": (lambda d: gzip.compress(d), True),
    "several_members": (lambda d: _members(d, 4099), True),
    "zero_padded": (lambda d: _members(d, 50_000) + b"\0" * 7, True),
    "one_member_big_ratio": (lambda d: gzip.compress(d * 40), True),
    "plain": (lambda d: d, False),
    "empty_gz": (lambda d: b"", True),
    "empty_plain": (lambda d: b"", False),
    "truncated": (lambda d: gzip.compress(d)[:-5], True),
    "trailing_garbage": (lambda d: gzip.compress(d) + b"x\0", True),
    "not_gzip": (lambda d: d, True),
    "bad_crc": (lambda d: (lambda z: z[:-8] + bytes([z[-8] ^ 1]) + z[-7:])(
        gzip.compress(d)), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_inflate_equals_python(tmp_path, case):
    data = _lines(np.random.default_rng(3), 20_000, 16)
    make, gz = CASES[case]
    path = tmp_path / "f"
    path.write_bytes(make(data))
    try:
        want = gzip.decompress(path.read_bytes()) if gz else path.read_bytes()
    except (OSError, EOFError):  # gzip.BadGzipFile is an OSError
        with pytest.raises(OSError):
            twl.read_bytes(str(path), gz).tobytes()
        return
    assert case not in ("truncated", "trailing_garbage", "not_gzip", "bad_crc")
    assert twl.read_bytes(str(path), gz).tobytes() == want


@pytest.mark.parametrize("text,k", [
    (b"ACGT\nTTGA\n", 4), (b"A\n", 1), (b"ACGTACGTACGTACGT\n" * 3, 16),
    (b"acgn\nNNNN\n", 4),  # not ACGT: read here, refused by the key table
    (b"ACGT\r\nTTGA\r\n", None),  # k 5 with \r at column 4: the table refuses
    (b"ACGT\rTTGA\r", None), (b"ACGT\nTTGA", None), (b"ACGT\nTTGA\n\n", None),
    (b"ACGT\nTTG\nGACGA\n", None), (b"\nACGT\n", None), (b"", None),
    (b"ACGTACGTACGTACGTA\n", None),
], ids=lambda v: repr(v)[:24])
def test_read_whitelist_words_are_the_line_list(tmp_path, text, k):
    path = tmp_path / "wl.txt.gz"
    path.write_bytes(gzip.compress(text))
    words = twl.read_whitelist(str(path))
    want = [ln[:-1] for ln in gzip.open(path, "rt")]
    if k is None and b"\r\n" in text:  # fixed stride, but the \r stays in the word
        assert words is not None and words.k == 5
        assert [words[i] for i in range(len(words))] == [w + "\r" for w in want]
        with pytest.raises(ValueError):
            build_key_table(words)
        return
    if k is None:
        assert words is None
        return
    assert words.k == k and len(words) == len(want) == words.rows.shape[0]
    assert [words[i] for i in range(len(words))] == want


def test_read_whitelist_counts_bytes_and_raises_oserror(tmp_path):
    from sctagger_tpu_torch import observability as obs

    path = tmp_path / "wl.txt"
    path.write_bytes(b"ACGT\n" * 9)
    with obs.stage_scope("s") as st:
        assert len(twl.read_whitelist(str(path))) == 9
    assert st.counters["whitelist.bytes"] == 45
    with pytest.raises(OSError):
        twl.read_whitelist(str(tmp_path / "missing.txt.gz"))
    (tmp_path / "cut.txt.gz").write_bytes(gzip.compress(b"ACGT\n" * 99)[:-9])
    with pytest.raises(OSError):
        twl.read_whitelist(str(tmp_path / "cut.txt.gz"))


@pytest.mark.parametrize("k", [8, 12, 16])
def test_key_table_from_the_buffer_equals_the_list(tmp_path, k):
    rng = np.random.default_rng(k)
    data = bytearray(_lines(rng, 5000, k))
    rows = np.frombuffer(data, np.uint8).reshape(-1, k + 1)
    rows[100:110] = rows[10:20]  # repeats: keep-last
    path = tmp_path / "wl.txt.gz"
    path.write_bytes(gzip.compress(bytes(data)))
    words = twl.read_whitelist(str(path))
    want = build_key_table([words[i] for i in range(len(words))])
    got = build_key_table(words)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].numel() < 2 * len(words)
