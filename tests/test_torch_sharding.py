"""The port's per-host input sharding (twin of test_sharding.py; the module
is a byte copy of sctagger_tpu/io/sharding.py, tests/test_torch_vendored.py):
per-host shards reassemble to the single-stream parse exactly, for any host
count, and equal the JAX package's shards."""

import gzip

import numpy as np
import pytest

from oracle import random_dna
from sctagger_tpu.io import sharding as jshard
from sctagger_tpu_torch.io.fastq import read_fastqs
from sctagger_tpu_torch.io.sharding import (
    fastq_record_counts,
    read_fastq_shard,
    read_tsv_shard,
    shard_ranges,
)


def _write_fastqs(tmp_path, rng):
    paths = []
    for fi, n_reads in enumerate([13, 1, 0, 27]):
        lines = []
        for i in range(n_reads):
            s = random_dna(rng, int(rng.integers(20, 60)))
            lines.append(f"@f{fi}r{i} comment\n{s}\n+\n{'I' * len(s)}\n")
        p = tmp_path / (f"part{fi}.fastq" if fi % 2 == 0 else f"part{fi}.fastq.gz")
        data = "".join(lines)
        if str(p).endswith(".gz"):
            p.write_bytes(gzip.compress(data.encode()))
        else:
            p.write_text(data)
        paths.append(str(p))
    return paths


def test_shard_ranges_cover():
    assert shard_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert shard_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    for total in (0, 1, 7, 100):
        for n in (1, 2, 3, 5):
            assert shard_ranges(total, n) == jshard.shard_ranges(total, n)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_fastq_shards_reassemble(tmp_path, n_hosts):
    rng = np.random.default_rng(0)
    paths = _write_fastqs(tmp_path, rng)
    ref_names, ref_seqs = read_fastqs(paths, gzipped=False, quiet=True)
    counts = fastq_record_counts(paths)
    assert sum(counts) == len(ref_names)
    all_names, all_seqs = [], []
    expected_start = 0
    for h in range(n_hosts):
        start, names, seqs = read_fastq_shard(paths, h, n_hosts, counts=counts)
        j_start, j_names, j_seqs = jshard.read_fastq_shard(paths, h, n_hosts, counts=counts)
        assert (start, list(names), list(seqs)) == (j_start, list(j_names), list(j_seqs))
        assert start == expected_start
        expected_start += len(names)
        all_names.extend(names)
        all_seqs.extend(seqs)
    assert all_names == list(ref_names)
    assert all_seqs == list(ref_seqs)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_tsv_shards_reassemble(tmp_path, n_hosts):
    rng = np.random.default_rng(1)
    rows = [f"r{i}\t0\t{i}\t{random_dna(rng, 20)}" for i in range(23)]
    path = tmp_path / "lr.tsv.gz"
    path.write_bytes(gzip.compress(("\n".join(rows) + "\n").encode()))
    got = []
    for h in range(n_hosts):
        start, lines = read_tsv_shard(str(path), h, n_hosts)
        assert (start, lines) == jshard.read_tsv_shard(str(path), h, n_hosts)
        assert start == len(got)
        got.extend(lines)
    assert got == rows
