"""`extract_sr_bc_from_lr` stage (torch port of
sctagger_tpu/stages/extract_sr_bc_from_lr.py): whitelist recovery from LR
segments.

Pipeline (reference scTagger.py:792-844): read the 10x whitelist (NOTE the
reference strips exactly one trailing char per line, `l[:-1]` — reproduced,
so a file without a trailing newline loses its last char; a file of
fixed-stride lines is read as one buffer, no string per line) and build its
key table -> exact-match every segment window against fwd+rc of every
whitelist barcode (ops/exact_lookup.py; the device probe on the card, the
host probe on the CPU) -> drop ambiguous reads (>1 hit) ->
count by abs(index), fwd/rc merged -> sort by count desc (ties keep
first-increment order) -> cap, chunked threshold cutoff -> TSV
`barcode \\t count` (gzipped when -o given).

With SCTAG_CHECKPOINT_DIR set, the probe runs in SCTAG_CHECKPOINT_BATCH-row
batches whose (counts, single_val) arrays persist as npz parts; a re-run
probes only the missing batches.

With --n-hosts > 1 each host probes a contiguous row shard of the LR TSV
(no checkpointing); the counts and first occurrences merge across hosts
(_rank_multi) and host 0 writes the output.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.cutoff import chunked_cutoff
from ..core.packing import rev_compl
from ..io.sharding import read_tsv_shard
from ..io.tsv import open_maybe_gz, open_out, read_lr_segments_tsv
from ..io.whitelist import read_whitelist
from ..observability import count, progress_bar, stage_scope
from ..ops.exact_lookup import build_key_table, host_dict_fallback, probe_segments
from ..ops.topk_count import count_and_rank_host
from ..parallel.multihost import make_host_group
from ..pipeline.checkpoint import PartStore, job_key
from ..runtime import resolve_device
from ..utils import batch_iter, full_fast


def run(args, device=None) -> None:
    """Run the stage on ``device`` (runtime.resolve_device, resolved before
    any input is read): the key table is built there and the probe follows
    it (ops/exact_lookup.probe_segments)."""
    dev = resolve_device(device)
    with stage_scope("extract_sr_bc_from_lr") as stats:
        _run(args, stats, dev)


def _run(args, stats, dev) -> None:
    n_hosts = getattr(args, "n_hosts", 1) or 1
    multi = n_hosts > 1
    barcodes, probe = _whitelist(args.barcode_whitelist, stats, dev)

    print(f"\n=====\nMatching exact barcodes on long-reads: {args.input}")
    with stats.timer("read_lr_tsv"):
        if multi:
            _, lines = read_tsv_shard(args.input, args.host_id, n_hosts)
            # tolerant parse (index, not unpack), as the native reader of
            # the single-host path: rows with > 4 fields behave the same at
            # any host count
            segments = []
            for line in lines:
                c = line.split("\t")
                if c[2] != "NA":
                    segments.append(c[3])
        else:
            _, _, locs, segs = read_lr_segments_tsv(args.input)
            keep = [i for i, p in enumerate(locs) if p != "NA"]
            take = getattr(segs, "take", None)
            segments = take(keep) if take else [segs[i] for i in keep]

    with stats.timer("probe"):
        counts_per_seg, single_val = _scan_with_checkpoint(args, segments, probe)

    matched = counts_per_seg == 1
    with stats.timer("rank"):
        vals = np.abs(single_val[matched]).astype(np.uint32)
        if multi:
            keys_ranked, counts_ranked = _rank_multi(args, barcodes, vals, n_hosts)
            if args.host_id != 0:
                return  # host 0 writes the single small output file
        else:
            # host count + rank by (count desc, first-increment asc) —
            # identical to the reference's insertion-ordered Counter +
            # stable reverse sort (scTagger.py:826-828)
            keys_ranked, counts_ranked = count_and_rank_host(vals)
        print(f"\n=====\nFound {len(keys_ranked):,} unique barcodes on long-reads")
        sorted_bc = [
            (int(k), int(c)) for k, c in zip(keys_ranked, counts_ranked)
        ][: args.max_barcode_cnt]
        sorted_bc = chunked_cutoff(sorted_bc, args.step_size, args.thresh)

    print(f"\n=====\nWriting the top {len(sorted_bc)} barcodes")
    with stats.timer("write"):
        outfile = open_out(args.outfile, force_gzip=True)
        for bc, c in sorted_bc:
            outfile.write(f"{barcodes[bc]}\t{c}\n")
        if outfile is not sys.stdout:
            outfile.close()


def _whitelist(path: str, stats, dev):
    """(barcodes, probe): the whitelist's words, and the probe of a batch of
    segments against them, by the key table (built on the probe's device)
    or by the host dict fallback. A file of fixed-stride lines is read as
    one buffer (io/whitelist.py) and its table built from that buffer; any
    other file, or one whose buffer the table refuses (\\r\\n endings,
    lowercase), is read again as the reference reads it: a list of lines,
    each less its last char. Counts ``whitelist.fixed_stride``."""
    table = None
    with stats.timer("read_whitelist"):
        try:
            barcodes = read_whitelist(path)
        except OSError:  # unreadable or not intact gzip: the line read raises
            barcodes = None
        if barcodes is not None:
            print(f"Reading whiltelist barcodes from: {path}")
    if barcodes is not None:
        with stats.timer("key_table"):
            try:
                table = build_key_table(barcodes, device=dev)
            except ValueError:  # \r\n endings, lowercase, N: the line list below
                pass
    count("whitelist.fixed_stride", int(table is not None))
    if table is None:
        with stats.timer("read_whitelist"):
            infile = open_maybe_gz(path)
            if barcodes is None:  # else printed above
                print(f"Reading whiltelist barcodes from: {path}")
            barcodes = [l[:-1] for l in infile]
            infile.close()
        with stats.timer("key_table"):
            try:
                # rc keys packed inside build_key_table (no rc strings), on
                # the stage's device
                table = build_key_table(barcodes, device=dev)
            except ValueError:
                print("whitelist not uniform ACGT; using host fallback", file=sys.stderr)
                barcodes_rc = [rev_compl(b) for b in barcodes]
                return barcodes, lambda batch: host_dict_fallback(batch, barcodes, barcodes_rc)
    sorted_keys, values = table
    k = len(barcodes[0])
    return barcodes, lambda batch: probe_segments(batch, sorted_keys, values, k=k, device=dev)


def _scan_with_checkpoint(args, segments, probe_fn):
    """Batch-granular scan cache for the whitelist probe (SCTAG_CHECKPOINT_DIR,
    like stage 1's scan cache): per-batch (counts, single_val) arrays persist
    as npz parts, so a killed run resumes at batch granularity with
    byte-identical output. Off for multi-host runs: shard-dependent batch
    contents would collide on one job key."""
    if (getattr(args, "n_hosts", 1) or 1) > 1:
        return probe_fn(segments)
    # batch size defines the part spans, so it keys the store (stale-span
    # reuse guard; see pipeline/checkpoint.py)
    batch = int(os.environ.get("SCTAG_CHECKPOINT_BATCH", 250_000))
    store = PartStore(
        "extract_sr_bc_from_lr_scan",
        job_key(
            "extract_sr_bc_from_lr_scan",
            [args.input, args.barcode_whitelist],
            {"m": args.max_barcode_cnt, "batch": batch},
        ),
    )
    if not store.enabled:
        return probe_fn(segments)
    counts_parts, val_parts = [], []
    bar = progress_bar(total=len(segments), desc="probe", unit="row")
    for bi, (s, e) in enumerate(batch_iter(len(segments), batch)):
        if store.has(bi, "npz"):
            d = store.load_arrays(bi)
        else:
            c, v = probe_fn(segments[s:e])
            d = {"counts": c, "single_val": v}
            store.save_arrays(bi, **d)
        counts_parts.append(d["counts"])
        val_parts.append(d["single_val"])
        bar.update(e - s)
    bar.close()
    if not counts_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(counts_parts), np.concatenate(val_parts)


def _rank_multi(args, barcodes, vals: np.ndarray, n_hosts: int):
    """Cross-host count merge preserving the reference's tie order.

    The reference ranks by (count desc, first-occurrence asc) over the global
    single-stream row order. Shards are contiguous row ranges, so a matched
    read's global insertion index = (# matched on earlier hosts) + local
    index; counts SUM-merge and first-occurrence indices MIN-merge (int64,
    the min identity included)."""
    group = make_host_group(
        args,
        "extract_sr_bc_from_lr",
        [args.input, args.barcode_whitelist],
        {"t": args.thresh, "s": args.step_size, "m": args.max_barcode_cnt},
    )
    per_host = group.allgather_scalar(vals.size)
    my_off = int(per_host[: args.host_id].sum())
    B = len(barcodes)
    cnt = np.bincount(vals, minlength=B).astype(np.int64)
    first = full_fast(B, np.iinfo(np.int64).max, np.int64)
    uniq, fidx = np.unique(vals, return_index=True)
    first[uniq] = my_off + fidx
    cnt = group.allreduce(cnt, "sum")
    first = group.allreduce(first, "min")
    nz = np.flatnonzero(cnt > 0)
    order = np.lexsort((first[nz], -cnt[nz]))
    ranked = nz[order]
    return ranked.astype(np.uint32), cnt[ranked]
