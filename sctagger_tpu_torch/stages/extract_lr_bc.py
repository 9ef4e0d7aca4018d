"""`extract_lr_bc` stage (torch port of sctagger_tpu/stages/extract_lr_bc.py).

Mirrors the reference pipeline (scTagger.py:362-383): FASTQ ingest ->
adapter scan (models/adapter.py) -> global range detection (host, unless
preset via -g) -> per-read filtering -> TSV (gzipped whenever -o is given)
-> optional plot.

Output row (scTagger.py:317-320): rname \t dist \t loc \t seq[s:e or None]
with Python slicing semantics (negative indices, e==0 -> slice to end), and
dist=-1 / loc='NA' / empty segment for invalid reads.

A single-host run streams: the FASTQ parse and the host prefilter's raw
scan run on a producer thread beside the scan (_run_stream).

Optional batch-granular checkpointing: with SCTAG_CHECKPOINT_DIR set, the
FASTQ is read whole and scanned in SCTAG_CHECKPOINT_BATCH-read batches whose
scan results persist as npz parts (pipeline/checkpoint); range detection,
filtering and the write re-run from the concatenated parts, so a re-run
scans only the missing batches and writes the same bytes.

With --n-hosts > 1 each host scans a contiguous read shard as one batch
(_run_multi: no checkpointing, no plot); the adapter-location histograms
merge across hosts so every host detects the same ranges, and host 0 merges
the hosts' rows into the one gz TSV.

Every route scans through models/adapter.scan_adapters_stream, the host
prefilter included.
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.ranges import (
    RangeMembership,
    detect_ranges,
    filter_alignments,
    find_peak_ranges_hist,
)
from ..io.fastq import read_fastqs, read_fastqs_stream
from ..io.sharding import read_fastq_shard
from ..io.tsv import open_out, write_lr_tsv_gz_native
from ..models.adapter import (
    AdapterScanResult,
    make_d0_scanner,
    scan_adapters_stream,
)
from ..observability import progress_bar, span, stage_scope
from ..parallel.multihost import make_host_group
from ..pipeline.checkpoint import PartStore, job_key
from ..runtime import resolve_device
from ..utils import batch_iter


def run(args, device=None) -> None:
    """Run the stage on ``device`` (runtime.resolve_device)."""
    dev = resolve_device(device)
    with stage_scope("extract_lr_bc") as stats:
        n_hosts = getattr(args, "n_hosts", 1) or 1
        if n_hosts > 1:
            _run_multi(args, stats, dev, n_hosts)
        else:
            _run(args, stats, dev)


def _detect_ranges_dist(group, locs_f: np.ndarray, locs_r: np.ndarray):
    """Cross-host range detection: the global int64 min and max of each
    strand's locations, then the SUM of its location histogram, so every
    host runs the same peak extraction."""
    quiet = group.host_id != 0
    out = []
    imax = np.iinfo(np.int64).max
    imin = np.iinfo(np.int64).min
    for locs, label in ((locs_f, "+"), (locs_r, "-")):
        locs = np.asarray(locs, dtype=np.int64)
        lmin = int(locs.min()) if locs.size else imax
        lmax = int(locs.max()) if locs.size else imin
        gmin = int(group.allreduce(np.array([lmin], np.int64), "min")[0])
        gmax = int(group.allreduce(np.array([lmax], np.int64), "max")[0])
        if gmin > gmax:  # no qualifying locations on any host
            ranges = []
        else:
            F = np.bincount(locs - gmin, minlength=gmax - gmin + 1)
            F = group.allreduce(F.astype(np.int64), "sum")
            ranges = find_peak_ranges_hist(F.astype(np.float64), gmin, quiet=quiet)
        if not quiet:
            print(f"Found these ranges on {label} strand:\t{ranges}", file=sys.stderr)
        out.append(ranges)
    return out


def _run_multi(args, stats, dev, n_hosts: int) -> None:
    """This host's contiguous shard of the reads, scanned as one batch, then
    the shared tail with the cross-host range detection and part merge."""
    assert args.plotfile is None, "plotting is single-host only"
    if os.environ.get("SCTAG_CHECKPOINT_DIR"):
        # shard-dependent batch contents would collide on one job key
        print("checkpointing disabled for multi-host runs", file=sys.stderr)
    group = make_host_group(
        args,
        "extract_lr_bc",
        list(args.reads),
        {"sa": args.short_read_adapter, "nb": args.num_bp_after},
    )
    with stats.timer("read_fastq"):
        _, rnames, seqs = read_fastq_shard(
            args.reads, args.host_id, n_hosts, args.gzipped
        )
    print(
        f"Aligning {args.short_read_adapter} to {len(seqs)} reads",
        file=sys.stderr,
    )
    with stats.timer("adapter_scan"):
        scan = scan_adapters_stream(
            [(rnames, seqs)], args.short_read_adapter, progress=True, device=dev
        )[2]
    stats.count("reads", len(seqs))
    _emit(args, stats, rnames, seqs, scan, group)


def _stream_batches(q):
    """Consumer-side iterator over the producer thread's parse queue."""
    while True:
        with span("scan.parse_wait"):
            item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _run_stream(args, stats, dev):
    """Streaming path: FASTQ parse and the prefilter's raw scan (producer
    thread + one probe worker, both in native code that releases the GIL)
    overlap packing, the kernel and collection (consumer). Returns
    (rnames, seqs: ChainSeqBuffer, scan)."""
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()  # consumer died: stop parsing, free the stream

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    # the prefilter's RAW scan runs beside the parse, on its own worker, so
    # batch i's probe overlaps batch i+1's parse; the apply half (small
    # numpy on the hit subsets) stays with the model
    d0 = make_d0_scanner(args.short_read_adapter)

    def _produce():
        # time the parse itself, not the q.put backpressure wait
        probe_pool = (ThreadPoolExecutor(1, thread_name_prefix="scan.d0probe")
                      if d0 is not None else None)

        def _timed_raw(sb):
            with span("scan.d0probe_raw"):
                return d0.raw(sb)

        try:
            it = read_fastqs_stream(args.reads, args.gzipped)
            bar = progress_bar(desc="reads", unit="read")
            try:
                while True:
                    with span("stage.read_fastq"):
                        b = next(it, None)
                    if b is not None:
                        bar.update(len(b[1]))
                        if d0 is not None:
                            b = (b[0], b[1], probe_pool.submit(_timed_raw, b[1]))
                    if not _put(b) or b is None:
                        return
            finally:
                bar.close()
                it.close()  # finalize: closes the native stream handle
        except BaseException as ex:  # surfaced by _stream_batches
            _put(ex)
        finally:
            if probe_pool is not None:
                # queued futures belong to batches the consumer will still
                # read: cancel them only when the consumer is gone
                probe_pool.shutdown(wait=False, cancel_futures=stop.is_set())

    threading.Thread(target=_produce, daemon=True, name="scan.parse").start()
    try:
        with stats.timer("adapter_scan"):
            rnames, seqs, scan = scan_adapters_stream(
                _stream_batches(q), args.short_read_adapter, progress=True,
                device=dev,
            )
    finally:
        stop.set()  # unblock the producer if we failed mid-stream
    print(
        f"Aligned {args.short_read_adapter} to {len(seqs)} reads",
        file=sys.stderr,
    )
    return rnames, seqs, scan


def _run(args, stats, dev) -> None:
    # the batch size defines each part's read span, so it keys the store (a
    # resume with a different batch would reuse parts with mismatched spans)
    batch = int(os.environ.get("SCTAG_CHECKPOINT_BATCH", 250_000))
    store = PartStore(
        "extract_lr_bc_scan",
        job_key(
            "extract_lr_bc_scan",
            list(args.reads),
            {"sa": args.short_read_adapter, "z": bool(args.gzipped),
             "batch": batch},
        ),
    )
    if args.outfile is not None:
        # fail fast on an unwritable output path BEFORE the expensive scan
        open(args.outfile, "wb").close()
    if store.enabled:
        with stats.timer("read_fastq"):
            rnames, seqs = read_fastqs(args.reads, args.gzipped)
        print(
            f"Aligning {args.short_read_adapter} to {len(seqs)} reads",
            file=sys.stderr,
        )
        with stats.timer("adapter_scan"):
            scan = _scan_checkpointed(args, stats, dev, store, batch, seqs)
    else:
        rnames, seqs, scan = _run_stream(args, stats, dev)
    stats.count("reads", len(seqs))
    _emit(args, stats, rnames, seqs, scan)


_SCAN_FIELDS = {"strands": np.int8, "dists": np.int32, "flat_locs": np.int64,
                "loc_counts": np.int64}


def _scan_checkpointed(args, stats, dev, store, batch: int, seqs):
    """The scan of each ``batch`` reads, each batch's result an npz part (the
    resume unit; a read's scan does not depend on its batch), the parts
    concatenated in read order."""
    parts = []
    for bi, (s, e) in enumerate(batch_iter(len(seqs), batch)):
        if store.has(bi, "npz"):
            parts.append(store.load_arrays(bi))
            stats.count("batches_skipped")
            continue
        r = scan_adapters_stream(
            [((), seqs[s:e])], args.short_read_adapter, progress=True, device=dev
        )[2]
        d = {name: getattr(r, name) for name in _SCAN_FIELDS}
        store.save_arrays(bi, **d)
        parts.append(d)
        stats.count("batches_computed")
    return AdapterScanResult(**{
        name: np.concatenate([p[name] for p in parts]) if parts
        else np.empty(0, dtype)
        for name, dtype in _SCAN_FIELDS.items()
    })


def _emit(args, stats, rnames, seqs, scan, group=None) -> None:
    """Shared stage tail: range detection -> filtering -> TSV -> plot.
    With a multi-host ``group`` the ranges come from the merged histograms
    and the rows go through the group's part merge."""
    with stats.timer("stage.ranges_filter"):
        preset = args.ranges
        if len(preset[0]) + len(preset[1]) == 0:
            if group is None or group.host_id == 0:
                print(
                    "No ranges for SR adapters have been preset. "
                    "Detecting directly from data...",
                    file=sys.stderr,
                )
            read_of = np.repeat(np.arange(len(seqs)), scan.loc_counts)
            in_window = (scan.dists >= 0) & (scan.dists <= 5)
            sel = in_window[read_of]
            is_fwd = (scan.strands == 0)[read_of]
            locs_f, locs_r = scan.flat_locs[sel & is_fwd], scan.flat_locs[sel & ~is_fwd]
            if group is None:
                ranges = detect_ranges(locs_f, locs_r)
            else:
                ranges = _detect_ranges_dist(group, locs_f, locs_r)
            memberships = [RangeMembership(r, include_end=False) for r in ranges]
        else:
            memberships = [RangeMembership(r, include_end=True) for r in preset]

        print("Filtering alignments using ranges", file=sys.stderr)
        dist, loc, s, e, valid = filter_alignments(
            scan.strands,
            scan.dists,
            scan.flat_locs,
            scan.loc_counts,
            memberships,
            args.num_bp_after,
        )
    # seq[s:e or None] without materializing full read strings (SeqBuffer);
    # the invalid-row segment seq[-1:-1] is always ''.
    substr = getattr(seqs, "substr", None) or (
        lambda i, a, b: seqs[i][a:b]
    )

    def _rows():
        # zip semantics of the reference: stop at the shorter list if a
        # trailing FASTQ record is truncated (name without sequence line)
        for i, rname in enumerate(rnames[: len(seqs)]):
            if valid[i]:
                si, ei = int(s[i]), int(e[i])
                yield f"{rname}\t{dist[i]}\t{loc[i]}\t{substr(i, si, ei or None)}\n"
            else:
                yield f"{rname}\t-1\tNA\t\n"

    if group is not None:
        with stats.timer("stage.write"):
            group.write_part_and_merge(
                args.outfile, "".join(_rows()),
                lambda p: open_out(p, force_gzip=True),
            )
        return

    with stats.timer("stage.write"):
        wrote = False
        if args.outfile is not None:
            print(f"Writng to {args.outfile}", file=sys.stderr)
            wrote = write_lr_tsv_gz_native(
                args.outfile, rnames, seqs, dist, loc, s, e, valid
            )
        if not wrote:
            outfile = open_out(args.outfile, force_gzip=True)
            if args.outfile is None:
                print(f"Writng to {outfile}", file=sys.stderr)
            # batched writes: per-row TextIOWrapper.write calls are slow
            rows = _rows()
            while True:
                chunk = list(itertools.islice(rows, 8192))
                if not chunk:
                    break
                outfile.write("".join(chunk))
            if outfile is not sys.stdout:
                outfile.close()

    if args.plotfile is not None:
        from ..plots import plot_extract_lr_bc

        plot_extract_lr_bc(rnames, dist, args.plotfile)
