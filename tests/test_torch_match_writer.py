"""The match_trie output writer (sctagger_tpu_torch/io/match_writer.py,
native/tsv_writer_mt.cpp) against stages.match_trie._render_rows, byte for
byte after decompression; its gzip members do not depend on the threads, and
every reader of a match output reads them as one stream (CPU)."""

import gzip
import zlib

import numpy as np
import pytest

from sctagger_tpu_torch.io import match_writer
from sctagger_tpu_torch.io import tsv
from sctagger_tpu_torch.io.fastq import SeqBuffer
from sctagger_tpu_torch.models.matcher import MatchResult
from sctagger_tpu_torch.stages.match_trie import _render_rows

K = 8  # tie slots a row holds; rows with more go to `overflow`


def _case(rng, n_reads: int, n_matched: int, max_ties: int):
    """(names, segs, barcodes, result): ``n_matched`` of ``n_reads`` reads
    matched, each with 1..max_ties ties."""
    alnum = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789_:-", np.uint8)
    names = [rng.choice(alnum, int(rng.integers(1, 41))).tobytes().decode()
             for _ in range(n_reads)]
    lens = rng.integers(0, 41, n_reads)
    offs = np.zeros(n_reads + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    buf = rng.choice(np.frombuffer(b"ACGTN", np.uint8), int(offs[-1]))
    barcodes = ["".join(rng.choice(list("ACGT"), 16)) for _ in range(30)]
    rids = np.sort(rng.choice(n_reads, n_matched, replace=False)).astype(np.int64)
    counts = rng.integers(1, max_ties + 1, n_matched).astype(np.int64)
    slots = np.full((n_matched, K), 1 << 40, np.int64)
    overflow = {}
    for i, c in enumerate(counts.tolist()):
        ties = np.sort(rng.choice(2 * len(barcodes), c, replace=False)).astype(np.int64)
        slots[i, :min(c, K)] = ties[:K]
        if c > K:
            overflow[int(rids[i])] = ties
    result = MatchResult(rids=rids, dists=rng.integers(0, 3, n_matched).astype(np.int32),
                         tie_counts=counts, tie_slots=slots, overflow=overflow)
    return names, SeqBuffer(buf, offs), barcodes, result


def _blocks(text: bytes, block: int) -> list[int]:
    """Sizes of the writer's blocks: rows in turn until a block holds at
    least ``block`` bytes; one empty block when there are no rows."""
    sizes, size = [], 0
    for row in text.splitlines(keepends=True):
        size += len(row)
        if size >= block:
            sizes, size = sizes + [size], 0
    return sizes + [size] if size or not sizes else sizes


def _members(data: bytes) -> list[int]:
    """Decompressed sizes of the gzip members of ``data``."""
    sizes = []
    while data:
        d = zlib.decompressobj(31)
        sizes.append(len(d.decompress(data)))
        assert d.eof
        data = d.unused_data
    return sizes


# case -> (reads, matched, most ties a row, block bytes, file name)
CASES = {
    "empty": (50, 0, 1, match_writer.BLOCK_BYTES, "out.tsv.gz"),
    "one_row": (50, 1, 3, match_writer.BLOCK_BYTES, "out.tsv.gz"),
    "many_blocks": (3000, 2000, 4, 16 << 10, "out.tsv.gz"),
    "many_ties": (400, 300, 20, 1 << 10, "out.tsv.gz"),
    "plain": (3000, 2000, 12, 16 << 10, "out.tsv"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_writer_matches_render_rows(tmp_path, monkeypatch, case):
    n_reads, n_matched, max_ties, block, fname = CASES[case]
    names, segs, barcodes, result = _case(np.random.default_rng(len(case)),
                                          n_reads, n_matched, max_ties)
    want = _render_rows(result, names, segs, barcodes).encode("latin-1")
    monkeypatch.setattr(match_writer, "BLOCK_BYTES", block)
    monkeypatch.setattr(match_writer, "_cores", lambda: 4)
    path = tmp_path / fname
    assert match_writer.write_match_tsv(str(path), names, segs, barcodes, result)
    data = path.read_bytes()
    if not fname.endswith("gz"):
        assert data == want
        return
    assert gzip.decompress(data) == want
    members = _members(data)
    assert members == _blocks(want, block)
    if case in ("many_blocks", "many_ties"):
        assert len(members) > 3
    # the cut depends on the rows alone: one worker, or more workers than
    # the host has cores, writes the same file
    for cores in (1, 64):
        monkeypatch.setattr(match_writer, "_cores", lambda: cores)
        other = tmp_path / f"{cores}.{fname}"
        assert match_writer.write_match_tsv(str(other), names, segs, barcodes, result)
        assert other.read_bytes() == data
    # zlib's gzread (the port's native TSV reader) reads every member
    got = tsv._read_lr_segments_native(str(path))
    rows = [ln.split(b"\t") for ln in want.splitlines()]
    assert got[0] == [r[0].decode() for r in rows]
    assert got[1] == [r[1].decode() for r in rows]
    assert list(got[3]) == [r[3].decode() for r in rows]
