"""`extract_lr_bc` stage (torch port of sctagger_tpu/stages/extract_lr_bc.py).

Mirrors the reference pipeline (scTagger.py:362-383): FASTQ ingest ->
adapter scan (models/adapter.py) -> global range detection (host, unless
preset via -g) -> per-read filtering -> TSV (gzipped whenever -o is given)
-> optional plot.

Output row (scTagger.py:317-320): rname \t dist \t loc \t seq[s:e or None]
with Python slicing semantics (negative indices, e==0 -> slice to end), and
dist=-1 / loc='NA' / empty segment for invalid reads.

Only the single-host, un-checkpointed path is ported; SCTAG_CHECKPOINT_DIR
and --n-hosts > 1 raise NotImplementedError (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sctagger_tpu.core.ranges import (
    RangeMembership,
    detect_ranges,
    filter_alignments,
)
from sctagger_tpu.io.fastq import read_fastqs, read_fastqs_stream
from sctagger_tpu.io.tsv import open_out, write_lr_tsv_gz_native
from sctagger_tpu.utils import PROF, prof_timer

from ..models.adapter import make_d0_scanner, scan_adapters, scan_adapters_stream
from ..observability import progress_bar, stage_scope
from ..runtime import resolve_device


def run(args, device=None) -> None:
    """Run the stage on ``device`` (runtime.resolve_device)."""
    if os.environ.get("SCTAG_CHECKPOINT_DIR"):
        raise NotImplementedError(
            "sctagger_tpu_torch extract_lr_bc: checkpointed batches "
            "(SCTAG_CHECKPOINT_DIR) are not ported yet (ROADMAP.md Queue A)"
        )
    if (getattr(args, "n_hosts", 1) or 1) > 1:
        raise NotImplementedError(
            "sctagger_tpu_torch extract_lr_bc: --n-hosts > 1 is not ported yet "
            "(ROADMAP.md Queue A)"
        )
    dev = resolve_device(device)
    PROF.clear()  # per-run phase timers (utils.prof_timer)
    with stage_scope("extract_lr_bc") as stats:
        _run(args, stats, dev)


def _stream_batches(q):
    """Consumer-side iterator over the producer thread's parse queue."""
    while True:
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
        probe_pool = ThreadPoolExecutor(1) if d0 is not None else None

        def _timed_raw(sb):
            with prof_timer("scan.d0probe_raw"):
                return d0.raw(sb)

        try:
            it = read_fastqs_stream(args.reads, args.gzipped)
            bar = progress_bar(desc="reads", unit="read")
            try:
                while True:
                    with prof_timer("stage.read_fastq"):
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

    threading.Thread(target=_produce, daemon=True).start()
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
    if args.outfile is not None:
        # fail fast on an unwritable output path BEFORE the expensive scan
        open(args.outfile, "wb").close()
    if os.environ.get("SCTAG_STREAM", "1") != "0":
        rnames, seqs, scan = _run_stream(args, stats, dev)
    else:
        with stats.timer("read_fastq"), prof_timer("stage.read_fastq"):
            rnames, seqs = read_fastqs(args.reads, args.gzipped)
        print(
            f"Aligning {args.short_read_adapter} to {len(seqs)} reads",
            file=sys.stderr,
        )
        with stats.timer("adapter_scan"):
            scan = scan_adapters(
                seqs, args.short_read_adapter, progress=True, device=dev
            )
    stats.count("reads", len(seqs))
    _emit(args, stats, rnames, seqs, scan)
    stats.timers.update(PROF)  # per-phase diagnostics (utils.prof_timer)


def _emit(args, stats, rnames, seqs, scan) -> None:
    """Shared stage tail: range detection -> filtering -> TSV -> plot."""
    rf_t = prof_timer("stage.ranges_filter").__enter__()
    preset = args.ranges
    if len(preset[0]) + len(preset[1]) == 0:
        print(
            "No ranges for SR adapters have been preset. "
            "Detecting directly from data...",
            file=sys.stderr,
        )
        read_of = np.repeat(np.arange(len(seqs)), scan.loc_counts)
        in_window = (scan.dists >= 0) & (scan.dists <= 5)
        sel = in_window[read_of]
        is_fwd = (scan.strands == 0)[read_of]
        ranges = detect_ranges(
            scan.flat_locs[sel & is_fwd], scan.flat_locs[sel & ~is_fwd]
        )
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

    rf_t.__exit__()
    stats.count("valid", int(valid.sum()))
    # per-distance read counts — the numbers the stage-1 plot encodes
    vals, cnts = np.unique(dist, return_counts=True)
    for v, c in zip(vals, cnts):
        stats.count(f"dist_{'NA' if v == -1 else int(v)}", int(c))
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

    with prof_timer("stage.write"):
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
        from sctagger_tpu.plots import plot_extract_lr_bc

        plot_extract_lr_bc(rnames, dist, args.plotfile)
