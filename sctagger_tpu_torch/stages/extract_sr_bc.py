"""`extract_sr_bc` stage (torch port of sctagger_tpu/stages/extract_sr_bc.py):
SR whitelist from a Cell Ranger BAM.

Pipeline (reference scTagger.py:469-509): BAM CB counts -> sort descending
(stable w.r.t. first appearance) -> cap --max-barcode-cnt -> coverage
histogram + elbow cutoff -> gzip TSV `barcode \\t count`.

This stage is host C++ in both packages (the BGZF/BAM reader in
native/bam_reader.cpp) and does no device work, so it runs without a card;
that is its design, not a CPU fallback.

Equal-count ordering: the reference's order among equal counts is the
nondeterministic imap_unordered arrival order (scTagger.py:445,474); with
-t 1 it reduces to the sequential scan's first-appearance order, which is
what the native reader preserves.

Checkpointing (SCTAG_CHECKPOINT_DIR): the scan is batched over compressed
byte ranges (SCTAG_SR_BATCH_BYTES each) through PartStore — each range's
(barcodes, counts, firsts) persists as an npz part, so a re-run scans only
the missing ranges. The merge ranks by (count desc, global first-appearance
asc), which equals the sequential scan's stable argsort: outputs are
byte-identical with or without checkpointing.

With --n-hosts > 1 each host scans its own compressed byte range
(_extract_multi; no checkpointing) and host 0 merges the counts and writes
the output.
"""

from __future__ import annotations

import io as _io
import json
import os
import sys
import time

import numpy as np

from ..core.cutoff import barcode_hist, elbow_cutoff
from ..io.bam import bam_file_size, extract_cb_counts, extract_cb_counts_range
from ..io.tsv import open_out
from ..observability import progress_bar, stage_scope
from ..parallel.multihost import make_host_group
from ..pipeline.checkpoint import PartStore, job_key

# compressed bytes per checkpoint batch: small enough that a crash loses
# seconds, large enough that the per-batch range-scan overhead (file reopen,
# thread spin-up) stays small
DEF_BATCH_BYTES = 512 << 20


def run(args) -> None:
    with stage_scope("extract_sr_bc") as stats:
        _run(args, stats)


def _run(args, stats) -> None:
    print(f"\n====\nExtracting SR barcodes from {args.input}:")  # stdout, as the reference (scTagger.py:434)
    n_hosts = getattr(args, "n_hosts", 1) or 1
    if n_hosts > 1:
        with stats.timer("bam_scan"):
            merged = _extract_multi(args, n_hosts)
        if merged is None:
            return  # non-zero hosts: host 0 writes the single output file
        top, total = merged
        top = top[: args.max_barcode_cnt]
    else:
        top, total = _extract_single(args, stats)

    with stats.timer("cutoff"):
        hist = barcode_hist(top, total=total, step_size=args.step_size)
        last_idx = elbow_cutoff(hist, n_barcodes=len(top), thresh=args.thresh)

    if args.plotfile is not None:
        from ..plots import plot_sr_bc_coverage

        plot_sr_bc_coverage(
            distribution=hist,
            step_size=args.step_size,
            last_idx=last_idx,
            outfile=args.plotfile,
        )

    print(f"\n=====\nWriting the top {last_idx} barcodes")
    with stats.timer("write"):
        outfile = open_out(args.outfile, force_gzip=True)
        for b, c in top[:last_idx]:
            outfile.write(f"{b}\t{c}\n")
        if outfile is not sys.stdout:
            outfile.close()


def _extract_single(args, stats):
    """One host: the whole-file scan, or the checkpointed byte ranges.
    Returns (top, total)."""
    # the scan itself is parameter-free (thresh/step/cap only affect the
    # cheap post-processing), so parts survive parameter tweaks — but the
    # batch byte size defines the per-part scan ranges, so it keys the store
    bb = int(os.environ.get("SCTAG_SR_BATCH_BYTES", DEF_BATCH_BYTES))
    store = PartStore(
        "extract_sr_bc",
        job_key("extract_sr_bc", [args.input], {"v": 1, "bb": bb}),
    )
    if store.enabled:
        with stats.timer("bam_scan"):
            parts = _scan_checkpointed(args, store, bb)
        print("\n=====\nCounting and sorting barcodes")
        with stats.timer("rank"):
            top, total = _merge_counts(parts)
            top = top[: args.max_barcode_cnt]
    else:
        with stats.timer("bam_scan"):
            barcodes, counts, total = extract_cb_counts(args.input)

        print("\n=====\nCounting and sorting barcodes")
        with stats.timer("rank"):
            order = np.argsort(-counts, kind="stable")[: args.max_barcode_cnt]
            top = [(barcodes[i], int(counts[i])) for i in order]
    return top, total


def _bam_threads() -> int:
    """Match the native default (bam_reader.cpp sctag_extract_cb): cores+1."""
    nt = os.environ.get("SCTAG_BAM_THREADS")
    return int(nt) if nt else (os.cpu_count() or 1) + 1


def _merge_counts(parts) -> tuple[list[tuple[str, int]], int]:
    """Merge per-range scan results into the global ranking.

    ``parts``: iterable of (barcodes, counts, firsts, total, kept) in scan
    order. Counts sum; each barcode's global first-appearance index is the
    min of (earlier parts' kept-record offset + local first), so ranking by
    (count desc, first asc) reproduces the sequential Counter insertion
    order byte-identically (scTagger.py:473-476 single-thread semantics)."""
    agg: dict[str, list[int]] = {}
    total_all = 0
    kept_off = 0
    for barcodes, counts, firsts, total, kept in parts:
        total_all += total
        for b, c, f in zip(barcodes, counts.tolist(), firsts.tolist()):
            g = kept_off + f
            e = agg.get(b)
            if e is None:
                agg[b] = [c, g]
            else:
                e[0] += c
                if g < e[1]:
                    e[1] = g
        kept_off += kept
    ranked = sorted(agg.items(), key=lambda kv: (-kv[1][0], kv[1][1]))
    return [(b, v[0]) for b, v in ranked], total_all


def _scan_checkpointed(args, store: PartStore, batch: int) -> list:
    """Batched whole-file scan with per-range npz parts (the resume unit).
    Returns the parts, in scan order, for _merge_counts."""
    size = bam_file_size(args.input)
    n_batches = max(1, -(-size // batch))
    bounds = [size * i // n_batches for i in range(n_batches + 1)]
    nthreads = _bam_threads()
    parts = []
    spill = 0
    bar = progress_bar(total=n_batches, desc="bam", unit="range")
    for i in range(n_batches):
        if store.has(i, "npz"):
            d = store.load_arrays(i)
            raw = d["barcodes"].tobytes().decode()
            barcodes = raw.split("\n") if raw else []
            total, kept, spill = (int(x) for x in d["meta"])
            parts.append((barcodes, d["counts"], d["firsts"], total, kept))
            bar.update(1)
            continue
        barcodes, counts, firsts, total, kept, sp, _ = extract_cb_counts_range(
            args.input, bounds[i], bounds[i + 1], spill,
            parse_header=(i == 0), nthreads=nthreads,
        )
        store.save_arrays(
            i,
            barcodes=np.frombuffer("\n".join(barcodes).encode(), np.uint8),
            counts=counts,
            firsts=firsts,
            meta=np.array([total, kept, sp], np.int64),
        )
        spill = sp
        parts.append((barcodes, counts, firsts, total, kept))
        bar.update(1)
    bar.close()
    return parts


def _pack_counts(barcodes, counts, firsts, total: int, kept: int) -> bytes:
    """Binary npz payload of one host's scan for the multi-host gather."""
    buf = _io.BytesIO()
    np.savez_compressed(
        buf,
        barcodes=np.frombuffer("\n".join(barcodes).encode(), np.uint8),
        counts=np.asarray(counts, np.int64),
        firsts=np.asarray(firsts, np.int64),
        meta=np.array([total, kept], np.int64),
    )
    return buf.getvalue()


def _unpack_counts(blob: bytes):
    with np.load(_io.BytesIO(blob)) as z:
        raw = z["barcodes"].tobytes().decode()
        barcodes = raw.split("\n") if raw else []
        return (
            barcodes,
            z["counts"],
            z["firsts"],
            int(z["meta"][0]),
            int(z["meta"][1]),
        )


def _extract_multi(args, n_hosts: int):
    """Sharded BAM scan over N hosts: each host inflates and parses a
    contiguous compressed byte range (block-aligned in the native reader)
    CONCURRENTLY. Records spanning a shard boundary belong to the shard
    where they START; host h > 0 discovers its first record boundary by
    self-synchronizing record-chain validation (bam_reader.cpp
    find_record_start), then RECONCILES the discovered offset against the
    authoritative spill from host h-1 (the ``spill.h{h}`` blob) once it
    arrives. On a mismatch, or when self-sync finds no boundary, the host
    rescans with the true skip, so output bytes never depend on the
    heuristic. Each host publishes its own spill only after reconciling.

    Per-host (scan_start, scan_end) wall times are published under
    ``scanwin.h{h}`` for overlap diagnostics (asserted in tests).

    The merge (_merge_counts) reconstructs the exact single-host output.
    Returns (top, total) on host 0, None elsewhere."""
    h = args.host_id
    group = make_host_group(
        args, "extract_sr_bc", [args.input],
        {"t": args.thresh, "s": args.step_size, "m": args.max_barcode_cnt},
    )
    size = bam_file_size(args.input)
    bounds = [size * i // n_hosts for i in range(n_hosts + 1)]
    t0 = time.monotonic()
    if h == 0:
        scan = extract_cb_counts_range(
            args.input, bounds[0], bounds[1], 0, parse_header=True
        )
        found = 0
    else:
        try:
            scan = extract_cb_counts_range(
                args.input, bounds[h], bounds[h + 1], -1, parse_header=False
            )
            found = scan[6]
        except RuntimeError:
            # no boundary validated, or a parse error from a falsely
            # accepted one: the speculative scan is best-effort, so every
            # failure routes to the authoritative-skip rescan below
            scan, found = None, None
    t1 = time.monotonic()
    group.put_bytes(f"scanwin.h{h}", json.dumps([t0, t1]).encode())
    if h > 0:
        true_skip = int.from_bytes(group.get_bytes(f"spill.h{h}"), "little")
        if scan is None or found != true_skip:
            scan = extract_cb_counts_range(
                args.input, bounds[h], bounds[h + 1], true_skip,
                parse_header=False,
            )
    barcodes, counts, firsts, total, kept, spill, _ = scan
    if h + 1 < n_hosts:
        group.put_bytes(f"spill.h{h + 1}", int(spill).to_bytes(8, "little"))
    parts = group.gather_bytes("srcounts", _pack_counts(barcodes, counts, firsts, total, kept))
    if parts is None:
        return None
    return _merge_counts(_unpack_counts(blob) for blob in parts)
