"""The adapter-scan kernel's plain version (sctagger_tpu_torch.ops
.adapter_cuda.adapter_scan_ref) against the Pallas kernel it ports, K6, run
in interpret mode on the CPU (adapter_scan_tpu(..., interpret=True), as
tests/test_adapter_pallas.py runs it).

Compared per read and strand: d exactly, min(cnt, 255) (the Pallas kernel
packs cnt into 16 bits clipped at 255), and the end slots below
min(cnt, SLOTS_K); the port's slots at or past that are -1 (the Pallas
kernel leaves stale values there). Tolerance: exact equality (all values
are integers)."""

import numpy as np
import pytest
import torch

from sctagger_tpu.core.packing import encode_seqs, encode_str, rev_compl
from sctagger_tpu.io.fastq import SeqBuffer
from sctagger_tpu.ops.adapter_pallas import adapter_scan_tpu
from sctagger_tpu.ops.myers import build_peq_multi
from sctagger_tpu_torch.ops import adapter_cuda as ac
from sctagger_tpu_torch.ops.myers import build_peq_multi as port_build_peq_multi

torch.set_num_threads(1)

ADAPTERS = {
    22: "CTACACGACGCTCTTCCGATCT",  # the default SR adapter
    31: "CTACACGACGCTCTTCCGATCTAGTCAGGTA",
    32: "CTACACGACGCTCTTCCGATCTAGTCAGGTAC",
}


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _mutate(rng, s: str, k: int) -> str:
    b = list(s)
    for _ in range(k):
        at = int(rng.integers(len(b)))
        op = int(rng.integers(3))
        if op == 0:
            b[at] = "ACGT"[int(rng.integers(4))]
        elif op == 1 and len(b) > 1:
            del b[at]
        else:
            b.insert(at, "ACGT"[int(rng.integers(4))])
    return "".join(b)


def _reads(adapter: str, seed: int) -> list[str]:
    """Ragged reads with planted (mutated) adapters on either strand, plus
    the edge cases: empty reads, reads shorter than m, a homopolymer, a
    read with more than SLOTS_K optimal ends, and reads spanning several
    512-char Pallas chunks."""
    rng = np.random.default_rng(seed)
    m = len(adapter)
    reads = []
    for _ in range(60):
        t = _dna(rng, int(rng.integers(30, 300)))
        r = rng.random()
        if r < 0.4:
            p = int(rng.integers(0, 25))
            t = t[:p] + _mutate(rng, adapter, int(rng.integers(0, 4))) + t[p:]
        elif r < 0.8:
            p = max(0, len(t) - int(rng.integers(5, 30)))
            t = t[:p] + _mutate(rng, rev_compl(adapter), int(rng.integers(0, 4))) + t[p:]
        reads.append(t)
    reads += ["", "", adapter[: m // 2], _dna(rng, m - 1), "A" * 40]
    reads.append("CC" + (adapter + "TTT") * 6 + "GG")  # 6 optimal ends
    reads.append((adapter[:-1] + "GA") * 5)  # more than 4 ends at d = 1
    for _ in range(2):
        t = _dna(rng, int(rng.integers(1200, 1600)))
        p = int(rng.integers(600, 1100))  # adapter in a middle chunk
        reads.append(t[:p] + adapter + t[p:])
    return reads


def _pallas(reads, adapter):
    m = len(adapter)
    peq2 = build_peq_multi(np.stack([encode_str(adapter), encode_str(rev_compl(adapter))]))
    codes, lens = encode_seqs(reads, pad_to=max(max(map(len, reads)), 1))
    return adapter_scan_tpu(codes, lens, peq2, m, interpret=True), peq2


def _port(reads, adapter, peq2):
    text, lens, junk = ac.pack_chunk(reads, np.arange(len(reads)), max(map(len, reads)))
    assert not junk.any()
    before = ac.LAUNCHES
    out = ac.adapter_scan(
        torch.from_numpy(text), torch.from_numpy(lens), ac.prep_peq(peq2), len(adapter)
    )
    assert ac.LAUNCHES == before  # CPU tensors never launch the kernel
    assert out.shape == (ac.N_OUT, len(reads)) and out.dtype == torch.int32
    return ac.unpack_scan_out(out.numpy(), len(reads))


@pytest.mark.parametrize("m", sorted(ADAPTERS))
def test_adapter_scan_ref_matches_pallas(m):
    adapter = ADAPTERS[m]
    reads = _reads(adapter, seed=m)
    (fwd, rc), peq2 = _pallas(reads, adapter)
    got = _port(reads, adapter, peq2)
    over = 0
    for want, have in zip((fwd, rc), got):
        np.testing.assert_array_equal(have["d"], want["d"])
        np.testing.assert_array_equal(np.minimum(have["cnt"], 255), np.minimum(want["cnt"], 255))
        filled = np.arange(ac.SLOTS_K)[None, :] < np.minimum(have["cnt"], ac.SLOTS_K)[:, None]
        np.testing.assert_array_equal(have["slots"][filled], want["slots"][filled])
        assert (have["slots"][~filled] == -1).all()
        over += int((have["cnt"] > ac.SLOTS_K).sum())
    assert over > 0  # the case with more than SLOTS_K ends is exercised
    empty = [i for i, r in enumerate(reads) if not r]
    for have in got:  # empty reads: d = m, no ends
        assert (have["d"][empty] == m).all() and (have["cnt"][empty] == 0).all()


def test_prep_peq_takes_build_peq_multi():
    """prep_peq takes the JAX package's (5, 2) build_peq_multi output as it
    is: rows = strands, columns = A, C, G, T; the pad row is dropped."""
    adapter = ADAPTERS[32]
    pat = np.stack([encode_str(adapter), encode_str(rev_compl(adapter))])
    peq2 = build_peq_multi(pat)
    np.testing.assert_array_equal(peq2, port_build_peq_multi(pat))
    got = ac.prep_peq(peq2)
    assert got.shape == (2, 4) and got.dtype == np.int32
    for p in range(2):
        for c in range(4):
            bits = sum(1 << i for i, x in enumerate(pat[p]) if x == c)
            assert int(np.uint32(got[p, c])) == bits  # bit 31 kept at m = 32
    with pytest.raises(ValueError, match="5, 2"):
        ac.prep_peq(peq2[:4])


def test_pack_chunk_native_equals_python():
    """The SeqBuffer (native) and list (numpy) packers give the same rows,
    lengths and junk flags; rows are whole 16-byte loads."""
    rng = np.random.default_rng(4)
    reads = [_dna(rng, int(rng.integers(0, 200))) for _ in range(30)]
    reads[3] = reads[3][:5] + "N" + reads[3][6:]
    reads[7] = "acgtNNNN"  # lowercase is junk under the strict table
    buf = np.frombuffer("".join(reads).encode(), np.uint8).copy()
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    idx = np.array([7, 3, 0, 12, 29, 5], np.int64)
    lmax = max(len(reads[i]) for i in idx)
    a = ac.pack_chunk(reads, idx, lmax)
    b = ac.pack_chunk(SeqBuffer(buf, offs), idx, lmax)
    assert a[0].shape[1] % 16 == 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[2].tolist() == [True, "N" in reads[3], False, False, False, False]


def test_wrapper_refuses_other_devices():
    meta = torch.empty((1, 16), dtype=torch.uint8, device="meta")
    lens = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no adapter-scan kernel"):
        ac.adapter_scan(meta, lens, np.zeros((2, 4), np.int32), 22)
