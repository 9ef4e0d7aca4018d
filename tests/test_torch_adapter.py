"""Stage-1 model of the port (sctagger_tpu_torch.models.adapter) against the
JAX package's (sctagger_tpu.models.adapter) on the CPU.

References: the JAX ``scan_adapters`` (its CPU mask path, every read through
``_hw_block``) and ``scan_adapters_stream(..., force_kernel=True)`` (the
Pallas kernel in interpret mode behind the host prefilter). The port runs
one path everywhere, through its one entry point scan_adapters_stream:
prefilter, the kernel's plain version, mask fallback.
Compared: strands, dists, flat_locs and loc_counts, exactly (integers).
Reads are 50-400 bp, as in tests/test_stream_scan.py, to keep interpret
mode fast."""

import numpy as np
import pytest
import torch

from sctagger_tpu.core.packing import STRICT_TABLE, encode_rows, encode_str, rev_compl
from sctagger_tpu.io.fastq import SeqBuffer
from sctagger_tpu.models import adapter as jax_adapter
from sctagger_tpu_torch.models import adapter as port
from sctagger_tpu_torch.ops import adapter_cuda
from sctagger_tpu_torch.observability import stage_scope

torch.set_num_threads(1)

ADAPTER = "CTACACGACGCTCTTCCGATCT"
ADAPTER_45 = ADAPTER + "AGTCAGGTACTTGCAGGCTAGGCTG"  # multi-word: mask path
ADAPTER_N = "CTACACGACGCTNTTCCGATCT"  # no prefilter; N matches nothing
ADAPTER_9 = ADAPTER[:9]  # below 10 bp: the exact d0 prefilter
FIELDS = ("strands", "dists", "flat_locs", "loc_counts")


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


def _gen_reads(rng, n, adapter, lo=50, hi=400):
    reads = []
    for _ in range(n):
        t = _dna(rng, int(rng.integers(lo, hi)))
        r = rng.random()
        if r < 0.35:
            p = int(rng.integers(0, 25))
            t = t[:p] + _mutate(rng, adapter, int(rng.integers(0, 3))) + t[p:]
        elif r < 0.7:
            p = max(0, len(t) - int(rng.integers(5, 30)))
            t = t[:p] + _mutate(rng, rev_compl(adapter), int(rng.integers(0, 3))) + t[p:]
        reads.append(t)
    return reads


def _batches(seed: int, adapter: str):
    """Three batches: plain reads; longer reads with a many-ends (overflow)
    read, a junk read with an exact hit and an exact 0/0 tie; short reads
    with an empty read, an all-N read and a junk read on the rc strand."""
    rng = np.random.default_rng(seed)
    b1 = _gen_reads(rng, 40, adapter)
    b2 = _gen_reads(rng, 20, adapter, lo=300, hi=400)
    b2.append("CC" + (adapter + "TTT") * 8 + "GG")  # cnt > SLOTS_K
    b2.append("GG" + "N" * 30 + adapter + _dna(rng, 60))  # junk + exact hit
    b2.append("AC" + adapter + "T" * 9 + rev_compl(adapter) + "GG")  # 0/0 tie
    b3 = _gen_reads(rng, 25, adapter) + ["", "N" * 40]
    b3.append("N" * 10 + rev_compl(_mutate(rng, adapter, 1)))
    return [b1, b2, b3]


def _sb(seqs):
    buf = np.frombuffer("".join(seqs).encode("latin-1"), dtype=np.uint8).copy()
    offs = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    return SeqBuffer(buf if buf.size else np.zeros(0, np.uint8), offs)


def _stream_items(parts):
    return iter([([f"b{k}r{i}" for i in range(len(p))], _sb(p)) for k, p in enumerate(parts)])


def _scan(seqs, adapter):
    """The port's scan of reads held in memory: one batch."""
    return port.scan_adapters_stream([((), seqs)], adapter, device="cpu")[2]


def _assert_same(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.fixture(scope="module")
def fixture_22():
    """The 22 bp fixture with both JAX references (which must agree)."""
    parts = _batches(31, ADAPTER)
    reads = [r for p in parts for r in p]
    mask_ref = jax_adapter.scan_adapters(reads, ADAPTER)
    _, _, kern_ref = jax_adapter.scan_adapters_stream(
        _stream_items(parts), ADAPTER, force_kernel=True
    )
    _assert_same(kern_ref, mask_ref)
    return parts, reads, mask_ref


@pytest.mark.parametrize("adapter", [ADAPTER, ADAPTER_45, ADAPTER_N], ids=["22bp", "45bp", "N"])
def test_scan_adapters_matches_jax(adapter):
    reads = [r for p in _batches(7, adapter) for r in p]
    want = jax_adapter.scan_adapters(reads, adapter)
    _assert_same(_scan(reads, adapter), want)
    _assert_same(_scan(_sb(reads), adapter), want)


@pytest.mark.parametrize("tier", ["d1", "d0", "off"])
def test_stream_matches_jax(fixture_22, monkeypatch, tier):
    """The scanner follows the adapter: d1 at 22 bp, d0 at 9 bp; ``off``
    takes the prefilter away, so every read goes to the kernel."""
    parts, reads, want = fixture_22
    adapter = ADAPTER
    if tier == "d0":
        adapter = ADAPTER_9
        parts = _batches(31, adapter)
        reads = [r for p in parts for r in p]
        want = jax_adapter.scan_adapters(reads, adapter)
    elif tier == "off":
        monkeypatch.setattr(port, "_make_d0_scanner", lambda pat, m: None)
    scanner = port.make_d0_scanner(adapter)
    assert type(scanner).__name__ == {"d1": "_D1Scanner", "d0": "_D0Scanner",
                                      "off": "NoneType"}[tier]
    with stage_scope("scan") as st:
        names, chain, got = port.scan_adapters_stream(
            _stream_items(parts), adapter, device="cpu"
        )
    counts = st.counters
    assert len(names) == len(reads) and list(chain) == reads
    _assert_same(got, want)
    kernel = counts.get("scan.kernel_reads", 0)
    resolved = sum(counts.get(f"scan.d{d}_resolved_reads", 0) for d in range(2))
    # every non-empty batch read is decided by the prefilter or the kernel
    assert resolved + kernel == len(reads)
    # junk and > SLOTS_K ends: the MASK entry (its plain version here), no
    # read through the plain-torch mask path
    assert kernel > 0 and counts.get("scan.mask_kernel_reads", 0) > 0
    assert counts.get("scan.mask_reads", 0) == 0
    assert (resolved > 0) == (tier != "off")
    assert (counts.get("scan.d1_resolved_reads", 0) > 0) == (tier == "d1")


@pytest.mark.parametrize("adapter", [ADAPTER_45, ADAPTER_N], ids=["45bp", "N"])
def test_stream_other_adapters_match_jax(adapter):
    parts = _batches(13, adapter)
    reads = [r for p in parts for r in p]
    want = jax_adapter.scan_adapters(reads, adapter)
    _, _, got = port.scan_adapters_stream(_stream_items(parts), adapter, device="cpu")
    _assert_same(got, want)


def test_stream_empty_input():
    names, chain, got = port.scan_adapters_stream(iter([]), ADAPTER, device="cpu")
    assert names == [] and len(chain) == 0
    assert got.strands.size == 0 and got.loc_counts.size == 0


def _true_min(reads, adapter):
    """Per read min over both strands of the exact HW distance (JAX mask
    path's _hw_block)."""
    import jax.numpy as jnp

    pat = np.stack([encode_str(adapter), encode_str(rev_compl(adapter))])
    peq2 = jax_adapter.build_peq_multi(pat)
    L = max(max(map(len, reads)), 1)
    codes, lens = encode_rows(reads, np.arange(len(reads)), pad_to=L)
    d, _ = jax_adapter._hw_block(
        jnp.asarray(codes.astype(np.int32).T), jnp.asarray(peq2),
        jnp.asarray(lens.astype(np.int32)), len(adapter),
    )
    return np.asarray(d).min(axis=1)


@pytest.mark.parametrize("tier", [1])
def test_prefilter_counts_each_tier_once(tier):
    """Each tier counts only the reads it decided: scan.d<t>_resolved_reads
    never exceeds the reads whose true min distance is t, and the tiers sum
    to the reads the prefilter took off the kernel path."""
    rng = np.random.default_rng(40 + tier)
    reads = _gen_reads(rng, 120, ADAPTER)
    with stage_scope("scan") as st:
        port.scan_adapters_stream(_stream_items([reads]), ADAPTER, device="cpu")
    true_min = _true_min(reads, ADAPTER)
    counts = [st.counters.get(f"scan.d{d}_resolved_reads", 0) for d in range(2)]
    for d in range(2):
        assert counts[d] <= (true_min == d).sum(), (d, counts)
    assert counts[1] > 0 and counts[0] < sum(counts)
    assert sum(counts) + st.counters["scan.kernel_reads"] == len(reads)


@pytest.mark.parametrize("tier", [1])
def test_prefilter_deferred_reads_counted(tier):
    """Reads the native d1 scan defers (candidate overflow, flags != 0)
    count as scan.prefilter_deferred_reads, and still come out exact."""
    rng = np.random.default_rng(60 + tier)
    part = ADAPTER[:11]  # one screen key, many times
    reads = _gen_reads(rng, 30, ADAPTER)
    reads += [(part + "T") * 300, "GG" + (part + "A") * 250 + ADAPTER]
    pat = np.stack([encode_str(ADAPTER, STRICT_TABLE),
                    encode_str(rev_compl(ADAPTER), STRICT_TABLE)])
    scanner = port._make_d0_scanner(pat, len(ADAPTER))
    assert type(scanner).__name__ == "_D1Scanner"
    flags = scanner.raw(_sb(reads))[-2]
    assert flags.sum() >= 2
    with stage_scope("scan") as st:
        _, _, got = port.scan_adapters_stream(_stream_items([reads]), ADAPTER, device="cpu")
    assert st.counters["scan.prefilter_deferred_reads"] == int((flags != 0).sum())
    _assert_same(got, jax_adapter.scan_adapters(reads, ADAPTER))


def test_chunks_follow_the_byte_budget(monkeypatch):
    """Reads are sorted by length and cut into chunks within the byte
    budget; the result does not depend on the cut. (No prefilter: every read
    goes to the kernel.)"""
    rng = np.random.default_rng(3)
    reads = _gen_reads(rng, 50, ADAPTER)
    want = jax_adapter.scan_adapters(reads, ADAPTER)
    launches = []
    real = adapter_cuda.adapter_scan

    def spy(text, lens, peq, m):
        launches.append((text.shape, lens.clone()))
        return real(text, lens, peq, m)

    monkeypatch.setattr(port, "adapter_scan", spy)
    monkeypatch.setattr(port, "CHUNK_READS", 16)
    monkeypatch.setattr(port, "_make_d0_scanner", lambda pat, m: None)
    _assert_same(_scan(reads, ADAPTER), want)
    assert [t[0] for t, _ in launches] == [16, 16, 16, 2]
    lens = torch.cat([ln for _, ln in launches])
    assert torch.equal(lens, lens.sort().values)  # length-sorted chunks
    for (b, row_bytes), ln in launches:  # rows padded to the chunk's longest
        assert row_bytes == -(-int(ln.max()) // 64) * 16
