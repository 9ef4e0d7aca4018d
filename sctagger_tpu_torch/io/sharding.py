"""Per-host input sharding for multi-host runs (SURVEY.md §2.3, §7).

Each host streams only its own slice of the input while global record ids
match the reference's single-stream order (scTagger.py:168-172) — required
because stage-3 output is sorted by read id (scTagger.py:777) and must be
byte-identical regardless of host count. Shards are contiguous ranges of the
global record index, balanced by record count.

Hosts process their shard independently; per-read results (fixed-size arrays)
are merged with the collectives in parallel/mesh.py or by concatenating
per-host artifact files in global order (the pipeline's stage checkpoint
contract).
"""

from __future__ import annotations

import gzip
from typing import Sequence

from .tsv import open_maybe_gz


def _open(path: str, gzipped: bool):
    if gzipped or path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def fastq_record_counts(paths: Sequence[str], gzipped: bool = False) -> list[int]:
    """Records per file = floor(lines/4), matching the reference's parser
    (it indexes lines modulo 4 per file)."""
    counts = []
    for p in paths:
        n = 0
        with _open(p, gzipped) as f:
            for n, _ in enumerate(f, start=1):
                pass
        counts.append(n // 4)
    return counts


def shard_ranges(total: int, n_hosts: int) -> list[tuple[int, int]]:
    """Contiguous [start, stop) global-record ranges, balanced +-1."""
    base, extra = divmod(total, n_hosts)
    out = []
    start = 0
    for h in range(n_hosts):
        stop = start + base + (1 if h < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def read_fastq_shard(
    paths: Sequence[str],
    host_id: int,
    n_hosts: int,
    gzipped: bool = False,
    counts: list[int] | None = None,
):
    """Parse only this host's records. Returns (global_start_rid, names, seqs).

    Name/sequence extraction matches io.fastq.read_fastqs exactly; complete
    records only (lines//4 per file, the reference's modulo-4 parse). The
    native C++ parser serves the records when available (each host decodes
    the full gzip stream anyway — seeking a .gz requires inflating from the
    start — so native full-parse + slicing beats the skip loop), with the
    Python loop as fallback and oracle.
    """
    try:
        return _read_fastq_shard_native(paths, host_id, n_hosts)
    except Exception:
        pass
    if counts is None:
        counts = fastq_record_counts(paths, gzipped)
    total = sum(counts)
    start, stop = shard_ranges(total, n_hosts)[host_id]

    names: list[str] = []
    seqs: list[str] = []
    file_start = 0
    for path, cnt in zip(paths, counts):
        file_stop = file_start + cnt
        lo = max(start, file_start)
        hi = min(stop, file_stop)
        if lo < hi:
            skip_records = lo - file_start
            take = hi - lo
            with _open(path, gzipped) as f:
                rec = -1
                taken = 0
                for idx, line in enumerate(f):
                    r = idx % 4
                    if r == 0:
                        rec += 1
                        if rec >= skip_records + take:
                            break
                    if rec < skip_records:
                        continue
                    if r == 0:
                        names.append(line.split()[0][1:])
                    elif r == 1:
                        seqs.append(line.rstrip())
                        taken += 1
        file_start = file_stop
    return start, names, seqs


def _read_fastq_shard_native(paths: Sequence[str], host_id: int, n_hosts: int):
    import numpy as np

    from ..native import build as native_build
    from .fastq import SeqBuffer, _read_fastq_native

    native_build.ensure_built()
    per_file = []  # (names, buf, offs) truncated to complete records
    counts = []
    owners = []  # keep the native zero-copy buffers alive until copied out
    for p in paths:
        names, buf, offs, n_lines, owner = _read_fastq_native(p)
        rec = n_lines // 4  # complete records only (reference parse)
        per_file.append((names[:rec], buf, offs[: rec + 1]))
        counts.append(rec)
        owners.append(owner)
    start, stop = shard_ranges(sum(counts), n_hosts)[host_id]

    out_names: list[str] = []
    bufs: list[np.ndarray] = []
    offs_parts: list[np.ndarray] = []
    file_start = 0
    for (names, buf, offs), cnt in zip(per_file, counts):
        lo = max(start, file_start)
        hi = min(stop, file_start + cnt)
        if lo < hi:
            a, b = lo - file_start, hi - file_start
            out_names.extend(names[a:b])
            bufs.append(buf)
            offs_parts.append(offs[a : b + 1])
        file_start += cnt
    if not offs_parts:
        return start, [], SeqBuffer(np.empty(0, np.uint8), np.zeros(1, np.int64))
    total_sz = sum(int(o[-1] - o[0]) for o in offs_parts)
    all_buf = np.zeros(total_sz, np.uint8)
    n_rec = sum(len(o) - 1 for o in offs_parts)
    all_offs = np.zeros(n_rec + 1, np.int64)
    bpos = 0
    npos = 0
    for buf, offs in zip(bufs, offs_parts):
        o0, o1 = int(offs[0]), int(offs[-1])
        all_buf[bpos : bpos + o1 - o0] = buf[o0:o1]
        cnt = len(offs) - 1
        np.add(offs[1:], bpos - o0, out=all_offs[npos + 1 : npos + 1 + cnt])
        bpos += o1 - o0
        npos += cnt
    return start, out_names, SeqBuffer(all_buf, all_offs)


def read_tsv_shard(path: str, host_id: int, n_hosts: int):
    """Shard a (possibly gzipped) TSV by row ranges. Returns
    (global_start_row, rows) with rows as raw lines (no trailing newline)."""
    with open_maybe_gz(path) as f:
        lines = [l.rstrip("\n") for l in f]
    start, stop = shard_ranges(len(lines), n_hosts)[host_id]
    return start, lines[start:stop]
