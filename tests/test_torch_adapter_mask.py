"""K6's MASK entry and SLOTS segment split on the CPU (their plain versions),
against the JAX package.

- MASK's plain version (``adapter_mask_ref``: d + bit-packed argmin mask)
  against the JAX mask path's ``_hw_block`` (sctagger_tpu/models/adapter.py)
  and, through the port's collection, against its ``_mask_chunk``: strands,
  dists, (rid, loc) pieces and reverse (rid, end) tasks. Reads carry junk,
  more than SLOTS_K ends, or are empty or shorter than m, at m 22/31/32.
- ``extract_lr_bc`` through the new routing (junk and > SLOTS_K-end reads go
  to the MASK wrapper, its plain version here) against
  ``python -m sctagger_tpu extract_lr_bc``: the same TSV bytes.
- The split of a read into segments (``adapter_scan_segments_ref`` +
  ``merge_segment_rows``, what the kernel computes) against the unsplit
  ``adapter_scan_ref``, with tie runs that cross segment borders.
- MASK's one-pass segmented scan (``adapter_mask_segments_ref``, what the
  MASK kernel computes) at every segment count against ``adapter_mask_ref``
  and the JAX ``_hw_block``; the cut of a read into whole mask words and
  the choice of the segment count.

Tolerance: exact equality (integers)."""

import functools
import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctagger_tpu.cli import main as jax_main
from sctagger_tpu.models import adapter as jax_adapter
from sctagger_tpu_torch.cli import main as torch_main
from sctagger_tpu_torch.core.packing import encode_rows, encode_str, rev_compl
from sctagger_tpu_torch.models import adapter as port
from sctagger_tpu_torch.ops import adapter_cuda as ac
from sctagger_tpu_torch.ops.myers import build_peq_multi

torch.set_num_threads(1)

ADAPTERS = {
    22: "CTACACGACGCTCTTCCGATCT",
    31: "CTACACGACGCTCTTCCGATCTAGTCAGGTA",
    32: "CTACACGACGCTCTTCCGATCTAGTCAGGTAC",
}


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _reads(rng, adapter: str) -> list[str]:
    """Junk inside, > SLOTS_K and > 64 ends, empty and < m reads, planted
    adapters on either strand."""
    m = len(adapter)
    reads = []
    for _ in range(40):
        t = _dna(rng, int(rng.integers(20, 400)))
        a = adapter if rng.random() < 0.5 else rev_compl(adapter)
        p = int(rng.integers(0, len(t)))
        t = t[:p] + a + t[p:]
        for i in np.flatnonzero(rng.random(len(t)) < 0.02):
            t = t[:i] + "N" + t[i + 1:]
        reads.append(t)
    reads += ["", "N" * 30, adapter[: m // 2], _dna(rng, m - 1),
              "CC" + (adapter + "TTT") * 6, "G" + (adapter + "A") * 70,
              "TT" + (rev_compl(adapter) + "C") * 5 + "N", adapter[:5] + "N" + adapter[6:]]
    return reads


def _inputs(reads, adapter):
    L = -(-max(1, max(map(len, reads))) // 32) * 32
    codes, lens = encode_rows(reads, np.arange(len(reads)), pad_to=L)
    pat = np.stack([encode_str(adapter), encode_str(rev_compl(adapter))])
    return codes, lens, build_peq_multi(pat)


@pytest.mark.parametrize("m", sorted(ADAPTERS))
def test_mask_ref_matches_jax_hw_block(m):
    adapter = ADAPTERS[m]
    reads = _reads(np.random.default_rng(m), adapter)
    codes, lens, peq2 = _inputs(reads, adapter)
    jd, jmask = jax_adapter._hw_block(
        jnp.asarray(codes.astype(np.int32).T), jnp.asarray(peq2),
        jnp.asarray(lens.astype(np.int32)), m,
    )
    d, bits = ac.adapter_mask(torch.from_numpy(codes), torch.from_numpy(lens),
                              ac.prep_peq(peq2), m)
    assert ac.MASK_LAUNCHES == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(d.numpy().T, np.asarray(jd))
    jmask = np.asarray(jmask)  # (L, B, 2)
    assert bits.shape == (len(reads), 2, codes.shape[1] // 32)
    for r in range(len(reads)):
        for p in range(2):
            np.testing.assert_array_equal(ac.mask_ends(bits[r, p].numpy()),
                                          np.flatnonzero(jmask[:, r, p]))
    ends = [ac.mask_ends(bits[r, 0].numpy()).size for r in range(len(reads))]
    assert max(ends) > 64 and sum(e > ac.SLOTS_K for e in ends) >= 2


@pytest.mark.parametrize("m", sorted(ADAPTERS))
def test_mask_collect_matches_jax_mask_chunk(m):
    adapter = ADAPTERS[m]
    reads = _reads(np.random.default_rng(100 + m), adapter)
    codes, lens, peq2 = _inputs(reads, adapter)
    n = len(reads)
    sub = np.arange(n, dtype=np.int64) + 7  # global ids of a later batch
    want = dict(strands=np.full(n + 7, -1, np.int8), dists=np.full(n + 7, -1, np.int32),
                loc_rids=[], loc_vals=[], rev_tasks_rid=[], rev_tasks_end=[])
    jax_adapter._mask_chunk(codes, lens, peq2, m, sub, **want)
    acc = port._Acc(n + 7)
    d, bits = ac.adapter_mask(torch.from_numpy(codes), torch.from_numpy(lens),
                              ac.prep_peq(peq2), m)
    port._mask_collect(d.T.numpy(), bits.numpy(), sub, acc)
    np.testing.assert_array_equal(acc.strands, want["strands"])
    np.testing.assert_array_equal(acc.dists, want["dists"])
    for got, key in ((acc.loc_rids, "loc_rids"), (acc.loc_vals, "loc_vals"),
                     (acc.rev_rids, "rev_tasks_rid"), (acc.rev_ends, "rev_tasks_end")):
        np.testing.assert_array_equal(_cat(got), _cat(want[key]), err_msg=key)


def _cat(pieces) -> np.ndarray:
    return np.concatenate([np.empty(0, np.int64), *pieces]).astype(np.int64)


def _fastq(path, rng, adapter):
    recs = []
    reads = _reads(rng, adapter) + [_dna(rng, int(rng.integers(50, 300))) for _ in range(30)]
    for i, s in enumerate(reads):
        recs.append(f"@r{i} x\n{s}\n+\n{'I' * len(s)}\n")
    path.write_text("".join(recs))


@pytest.mark.parametrize("stream", ["1", "0"], ids=["stream", "one-shot"])
def test_extract_lr_bc_routes_through_mask(tmp_path, monkeypatch, stream):
    """The streamed route, and (``one-shot``) the checkpointed one, which
    reads the FASTQ whole."""
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    if stream == "0":
        monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    fq = tmp_path / "r.fastq"
    _fastq(fq, np.random.default_rng(9), ADAPTERS[22])
    stats = tmp_path / "stats.jsonl"
    monkeypatch.setenv("SCTAG_STATS", str(stats))
    torch_main(["extract_lr_bc", "-r", str(fq), "-o", str(tmp_path / "t.tsv.gz")])
    monkeypatch.delenv("SCTAG_STATS")
    monkeypatch.delenv("SCTAG_CHECKPOINT_DIR", raising=False)  # JAX: its own scan
    counts = json.loads(stats.read_text())["counters"]  # the stage_scope's record
    assert counts.get("scan.mask_kernel_reads", 0) > 0
    assert counts.get("scan.mask_reads", 0) == 0
    jax_main(["extract_lr_bc", "-r", str(fq), "-o", str(tmp_path / "j.tsv.gz")])
    got = gzip.decompress((tmp_path / "t.tsv.gz").read_bytes())
    assert got == gzip.decompress((tmp_path / "j.tsv.gz").read_bytes())
    assert got.count(b"\n") == 78


def _tie_runs(rng, adapter: str) -> list[str]:
    """Reads whose optimal ends form runs that cross segment borders: a
    homopolymer against a homopolymer-rich pattern, repeats of the adapter
    every 70 and 64 chars, and random reads."""
    reads = ["A" * 700, "A" * 130 + "C" + "A" * 300,
             (adapter + "G" * (70 - len(adapter))) * 12,
             (adapter + "T" * (64 - len(adapter))) * 16 + adapter[:10]]
    reads += [_dna(rng, int(rng.integers(0, 900))) for _ in range(40)]
    reads += ["", adapter[:3], "CC" + (adapter + "TTT") * 12]
    return sorted(reads, key=len)


@pytest.mark.parametrize("adapter", ["AAAAAAAA", ADAPTERS[22], ADAPTERS[32]],
                         ids=["m8-homopolymer", "m22", "m32"])
def test_segment_merge_equals_unsplit(adapter):
    m = len(adapter)
    reads = _tie_runs(np.random.default_rng(m), adapter)
    text, lens, _ = ac.pack_chunk(reads, np.arange(len(reads)), max(map(len, reads)))
    pat = np.stack([encode_str(adapter), encode_str(rev_compl(adapter))])
    peq = ac.prep_peq(build_peq_multi(pat))
    t, ln = torch.from_numpy(text), torch.from_numpy(lens)
    want = ac.adapter_scan_ref(t, ln, peq, m)
    split_ties = 0
    for nseg in (1, 2, 4, 8, 16, 32):
        rows = ac.adapter_scan_segments_ref(t, ln, peq, m, nseg)
        assert torch.equal(ac.merge_segment_rows(rows), want), nseg
        # reads whose min-score ends fall in more than one segment
        at_min = (rows[..., 0] == want.T.reshape(-1, 2, 6)[:, None, :, 0]) & (rows[..., 1] > 0)
        split_ties += int((at_min.sum(dim=1) > 1).sum())
    assert split_ties > 0


def test_segment_bounds_cover_each_read_once():
    lens = torch.tensor([0, 1, 63, 64, 65, 700, 2999, 72_001])
    for nseg in (1, 2, 8, 32):
        lo, hi, w0 = ac.segment_bounds(lens, nseg, 22)
        covered = torch.clamp(hi - lo, min=0).sum(dim=1)
        assert torch.equal(covered, lens)
        assert bool((lo % ac.SEG_CHARS == 0).all()) and bool((w0 % 16 == 0).all())
        assert bool(((w0 <= lo - 44) | (w0 == 0)).all())


def test_nseg_fills_the_card_for_small_chunks():
    assert ac.nseg_for(131_072, 752) == 1
    assert ac.nseg_for(16_384, 752) == 4
    assert ac.nseg_for(300, 752) > ac.nseg_for(16_384, 752)
    assert ac.nseg_for(300, 16) == 1  # rows too short to split
    assert all(ac.nseg_for(b, rb) in (1, 2, 4, 8, 16, 32)
               for b in (1, 300, 16_384, 10**6) for rb in (16, 752, 18_000))


def _mask_reads(rng, adapter: str) -> list[str]:
    """Junk, > SLOTS_K and > 64 ends, reads shorter than m and than 2m,
    empty reads, ragged lengths, and tie runs that cross word and segment
    borders (a homopolymer, adapter repeats every 70 and 64 chars)."""
    m = len(adapter)
    reads = _reads(rng, adapter)[::2]
    reads += [_dna(rng, 2 * m - 1), _dna(rng, m + 1), "", "A" * 700,
              "A" * 130 + "C" + "A" * 300, (adapter + "G" * (70 - m)) * 6,
              (adapter + "T" * (64 - m)) * 8 + adapter[:10]]
    reads += [_dna(rng, int(rng.integers(0, 900))) for _ in range(12)]
    return reads


@functools.lru_cache(maxsize=None)
def _mask_case(m: int):
    """(codes, lens, peq2, JAX d (B, 2), JAX mask (L, B, 2)) of m's reads."""
    adapter = ADAPTERS[m]
    codes, lens, peq2 = _inputs(_mask_reads(np.random.default_rng(200 + m), adapter),
                                adapter)
    jd, jmask = jax_adapter._hw_block(
        jnp.asarray(codes.astype(np.int32).T), jnp.asarray(peq2),
        jnp.asarray(lens.astype(np.int32)), m,
    )
    return codes, lens, peq2, np.asarray(jd), np.asarray(jmask)


@pytest.mark.parametrize("nseg", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("m", sorted(ADAPTERS))
def test_mask_segments_ref_matches_ref_and_jax(m, nseg):
    codes, lens, peq2, jd, jmask = _mask_case(m)
    c, ln, peq = torch.from_numpy(codes), torch.from_numpy(lens), ac.prep_peq(peq2)
    d, bits = ac.adapter_mask_segments_ref(c, ln, peq, m, nseg)
    want_d, want_bits = ac.adapter_mask_ref(c, ln, peq, m)
    assert torch.equal(d, want_d) and torch.equal(bits, want_bits)
    np.testing.assert_array_equal(d.numpy().T, jd)
    for r in range(len(lens)):
        for p in range(2):
            np.testing.assert_array_equal(ac.mask_ends(bits[r, p].numpy()),
                                          np.flatnonzero(jmask[:, r, p]))
    # the reads' minima fall in several segments and in several words
    lo, hi, _ = ac.segment_bounds(ln, nseg, m, unit=ac.MASK_WORD)
    spread = words = 0
    for r in range(len(lens)):
        ends = ac.mask_ends(bits[r, 0].numpy())
        segs = {int(((lo[r] <= e) & (e < hi[r])).nonzero()[0]) for e in ends}
        spread += len(segs) > 1
        words += len(set(ends >> 5)) > 1
    assert words > 0 and (spread > 0 or nseg == 1)


@pytest.mark.parametrize("nseg", [1, 2, 4, 8, 16, 32])
def test_mask_segments_cover_each_read_once(nseg):
    """MASK's cut: whole words, each position in exactly one segment, a
    warm-up of 2m to 64 chars (at most 4 loads of 16) before each."""
    lens = torch.tensor([0, 1, 21, 31, 32, 33, 43, 44, 64, 65, 700, 1000, 2999, 3008,
                         72_001])
    for m in (1, 22, 32):
        lo, hi, w0 = ac.segment_bounds(lens, nseg, m, unit=ac.MASK_WORD)
        assert torch.equal(torch.clamp(hi - lo, min=0).sum(dim=1), lens)
        pos = torch.arange(int(lens.max()))
        inside = ((lo[:, :, None] <= pos) & (pos < hi[:, :, None])).sum(dim=1)
        assert torch.equal(inside, (pos < lens[:, None]).long())
        assert bool((lo % ac.MASK_WORD == 0).all()) and bool((w0 % 16 == 0).all())
        assert bool(((w0 <= lo - 2 * m) | (w0 == 0)).all())
        assert bool((lo - w0 <= 64).all())


def test_mask_nseg_sized_to_the_launch():
    assert ac.mask_nseg_for(102, 3008) == 32  # the main path's launch: short chains
    assert ac.mask_nseg_for(4096, 3008) == 8  # the largest: ~256-char segments
    assert ac.mask_nseg_for(1, 32) == 1  # rows too short to split
    assert ac.mask_nseg_for(2048, 3008) == 16
    for b in (1, 100, 4096, 10**5):
        for row_len in (32, 1024, 3008, 72_032):
            n = ac.mask_nseg_for(b, row_len)
            assert n in (1, 2, 4, 8, 16, 32)
            assert row_len // n >= ac.MASK_MIN_SEG or n == 1
            assert (n == ac.MASK_MAX_NSEG or 2 * b * n >= ac.MASK_TARGET_THREADS
                    or row_len // (2 * n) < ac.MASK_MIN_SEG)


@pytest.mark.parametrize("nseg,log", [(1, 0), (2, 1), (4, 2), (8, 3), (16, 4), (32, 5),
                                      (3, None), (64, None), (0, None)])
def test_mask_nseg_hook_values(nseg, log):
    if log is None:
        with pytest.raises(ValueError, match="power of two"):
            ac._check_nseg(nseg, ac.MASK_MAX_NSEG)
    else:
        assert ac._check_nseg(nseg, ac.MASK_MAX_NSEG) == log


def test_mask_wrapper_cpu_and_other_devices():
    """CPU tensors take the plain version (no launch, the hook aside); any
    other device raises; nothing falls back."""
    codes, lens, peq2, jd, _ = _mask_case(22)
    c, ln, peq = torch.from_numpy(codes), torch.from_numpy(lens), ac.prep_peq(peq2)
    before = ac.MASK_LAUNCHES
    d, _ = ac.adapter_mask(c, ln, peq, 22, nseg=4)
    assert ac.MASK_LAUNCHES == before
    np.testing.assert_array_equal(d.numpy().T, jd)
    with pytest.raises(ValueError, match="no adapter-mask kernel"):
        ac.adapter_mask(c.to("meta"), ln.to("meta"), peq, 22)
