"""`match_trie` stage (torch port of sctagger_tpu/stages/match_trie.py).

Input/behavior contract (scTagger.py:758-790), unchanged:
  * barcodes: col 0 of the SR TSV, in file order (bid = line index); all must
    have uniform length == --barcode-length (asserted).
  * long reads: cols 0 and 3 of EVERY row of the LR TSV (including dist=-1
    rows, whose segment is empty and can never match).
  * output row per MATCHED read only, ascending read id:
      name \t e \t n_bids \t seg \t bc1,bc2,...
    where the tie list is sorted by (bid, strand) with strand False (revcomp)
    before True (forward), and revcomp matches print rev_compl(barcode).
  * output gzipped only if the path ends with 'gz'.
  * --mem and --plotfile are accepted and unused.

Optional batch-granular checkpointing: with SCTAG_CHECKPOINT_DIR set, the
input is matched in SCTAG_CHECKPOINT_BATCH-row batches whose rendered rows
persist as part files; re-runs skip completed batches (pipeline/checkpoint).
Batches are contiguous rid ranges and output rows are ascending-rid within a
batch, so concatenating the parts reproduces the exact global output.

With --n-hosts > 1 each host matches a contiguous row shard of the LR TSV
(_run_multi; no checkpointing) and host 0 merges the hosts' rows.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

from ..core.packing import rev_compl
from ..io.match_writer import write_match_tsv
from ..io.sharding import read_tsv_shard
from ..io.tsv import open_out, read_lr_segments_tsv, read_sr_barcodes_tsv
from ..models.matcher import MatchContext, match_segments
from ..observability import StageStats, progress_bar, stage_scope
from ..parallel.multihost import make_host_group
from ..pipeline.checkpoint import PartStore, job_key
from ..runtime import resolve_device
from ..utils import batch_iter


def run(args, device=None) -> None:
    """Run the stage on ``device`` (runtime.resolve_device: the card unless
    asked for the CPU), resolved before any input is read."""
    dev = resolve_device(device)
    with stage_scope("match_trie") as stats:
        _run(args, stats, dev)


def _render_rows(result, names, segs, barcodes, rid_offset: int = 0) -> str:
    fwd_strs = list(barcodes)
    rc_strs = [rev_compl(b) for b in barcodes]
    out = []
    for i in range(result.rids.size):
        rid = int(result.rids[i])
        ties = result.ties_of(i)
        matches = ",".join(
            fwd_strs[p >> 1] if p & 1 else rc_strs[p >> 1] for p in ties
        )
        out.append(
            f"{names[rid_offset + rid]}\t{result.dists[i]}\t{ties.size}\t"
            f"{segs[rid]}\t{matches}\n"
        )
    return "".join(out)


def _run(args, stats, device) -> None:
    n_hosts = getattr(args, "n_hosts", 1) or 1
    with stats.timer("read"):
        barcodes = read_sr_barcodes_tsv(args.short_read_barcodes)
        print(f"There are {len(barcodes):,} SR barcodes", file=sys.stderr)
        barcode_lens = {len(b) for b in barcodes}
        assert barcode_lens == {args.barcode_length}, barcode_lens
    if n_hosts > 1:
        _run_multi(args, stats, device, barcodes, n_hosts)
        return
    with stats.timer("read"):
        names, _, _, segs = read_lr_segments_tsv(args.long_read_segments)
        print(f"There are {len(names):,} LRs", file=sys.stderr)
    stats.count("reads", len(names))

    # the batch size defines the part spans, so it keys the store: a resume
    # with a different SCTAG_CHECKPOINT_BATCH must not reuse parts whose row
    # spans no longer match
    batch = int(os.environ.get("SCTAG_CHECKPOINT_BATCH", 524_288))
    store = PartStore(
        "match_trie",
        job_key(
            "match_trie",
            [args.long_read_segments, args.short_read_barcodes],
            {"mr": args.max_error, "bl": args.barcode_length, "batch": batch},
        ),
    )
    if args.outfile is not None:
        # fail fast on an unwritable output path BEFORE the expensive match
        open(args.outfile, "wb").close()
    if store.enabled:
        n_matched = _run_checkpointed(
            args, stats, device, store, batch, names, segs, barcodes
        )
        stats.count("matched", n_matched)
        return
    result = match_segments(
        segments=segs,
        barcodes=barcodes,
        max_error=args.max_error,
        progress=True,
        device=device,
        stats=stats,
    )
    with stats.timer("write"):
        wrote = False
        if args.outfile is not None:
            wrote = write_match_tsv(args.outfile, names, segs, barcodes, result)
        if not wrote:
            outfile = open_out(args.outfile, force_gzip=False)
            outfile.write(_render_rows(result, names, segs, barcodes))
            if outfile is not sys.stdout:
                outfile.close()
    stats.count("matched", int(result.rids.size))


def _ascii_batch(names, s: int, e: int, seg_b) -> bool:
    """True iff the batch's names and segment bytes are pure ASCII (then the
    native latin-1 part bytes decode identically under load_text's UTF-8)."""
    if not all(n.isascii() for n in names[s:e]):
        return False
    buf = getattr(seg_b, "buf", None)
    offs = getattr(seg_b, "offs", None)
    if buf is None or offs is None or len(seg_b) == 0:
        return buf is not None
    lo, hi = int(offs[0]), int(offs[-1])
    return not bool((buf[lo:hi] > 127).any())


def _run_checkpointed(args, stats, device, store, batch, names, segs,
                      barcodes) -> int:
    """Match in ``batch``-row batches, each part written (or loaded, when
    the store has it) in batch order; returns the matched row count.

    One MatchContext (Peq table, neighborhood index) serves every batch. Two
    batches run at once on a 2-worker pool, so batch bi + 1's host phases
    (encode, prefilter probe, dispatch) overlap batch bi's device tail and
    part write. Both workers launch on the device's default stream (neither
    sets a stream of its own), so the kernels of the two batches queue in
    order on one stream; the launch counters are locked
    (ops/match_cuda._count); each batch keeps its own StageStats, merged
    into ``stats`` here, on this thread."""
    ctx = MatchContext(barcodes)
    spans = list(batch_iter(len(segs), batch))

    def _match(bi: int):
        s, e = spans[bi]
        bstats = StageStats("match_trie")
        result = match_segments(
            segments=segs[s:e],
            barcodes=barcodes,
            max_error=args.max_error,
            progress=True,
            ctx=ctx,
            device=device,
            stats=bstats,
        )
        return result, bstats

    pool = ThreadPoolExecutor(2, thread_name_prefix="match.batch")
    futs: dict = {}

    def _ensure(bi: int) -> None:
        if 0 <= bi < len(spans) and bi not in futs and not store.has(bi, "tsv"):
            futs[bi] = pool.submit(_match, bi)

    n_matched = 0
    outfile = open_out(args.outfile, force_gzip=False)
    bar = progress_bar(total=len(segs), desc="match", unit="seg")
    try:
        _ensure(0)
        _ensure(1)
        for bi, (s, e) in enumerate(spans):
            _ensure(bi + 1)
            done = futs.pop(bi).result() if bi in futs else None
            _ensure(bi + 2)
            if done is None:
                stats.count("batches_skipped")
            else:
                result, bstats = done
                stats.merge(bstats)
                seg_b = segs[s:e]
                # part files are read back with load_text (UTF-8); the native
                # writer emits raw latin-1 bytes, which only coincide for
                # ASCII: non-ASCII batches take the Python text path
                ok = _ascii_batch(names, s, e, seg_b) and store.save_file(
                    bi, "tsv",
                    lambda p: write_match_tsv(p, names[s:e], seg_b, barcodes, result),
                )
                if not ok:
                    store.save_text(
                        bi, _render_rows(result, names, seg_b, barcodes, rid_offset=s)
                    )
                stats.count("batches_computed")
            text = store.load_text(bi)
            n_matched += text.count("\n")
            outfile.write(text)
            bar.update(e - s)
    finally:
        bar.close()
        pool.shutdown(wait=True, cancel_futures=True)
        if outfile is not sys.stdout:
            outfile.close()
    return n_matched


def _run_multi(args, stats, device, barcodes, n_hosts: int) -> None:
    """Sharded flagship: contiguous LR row ranges per host, replicated
    whitelist, host-0 part merge. Shards are contiguous global-rid ranges and
    rows render in ascending rid within a shard, so concatenation reproduces
    the single-stream sorted-by-rid output byte for byte (scTagger.py:777)."""
    group = make_host_group(
        args,
        "match_trie",
        [args.long_read_segments, args.short_read_barcodes],
        {"mr": args.max_error, "bl": args.barcode_length},
    )
    _, lines = read_tsv_shard(args.long_read_segments, args.host_id, n_hosts)
    names, segs = [], []
    for line in lines:
        c = line.split("\t")
        names.append(c[0])
        segs.append(c[3])
    print(
        f"[host {args.host_id}/{n_hosts}] {len(names):,} LRs in shard",
        file=sys.stderr,
    )
    stats.count("reads", len(names))
    result = match_segments(
        segments=segs,
        barcodes=barcodes,
        max_error=args.max_error,
        progress=True,
        device=device,
        stats=stats,
    )
    with stats.timer("write"):
        text = _render_rows(result, names, segs, barcodes)
        group.write_part_and_merge(
            args.outfile, text, lambda p: open_out(p, force_gzip=False)
        )
    stats.count("matched", int(result.rids.size))
