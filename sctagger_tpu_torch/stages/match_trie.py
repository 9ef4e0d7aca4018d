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

Only the single-host, un-checkpointed path is ported; SCTAG_CHECKPOINT_DIR
and --n-hosts > 1 raise NotImplementedError (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import os
import sys

from sctagger_tpu.core.packing import rev_compl
from sctagger_tpu.io.tsv import (
    open_out,
    read_lr_segments_tsv,
    read_sr_barcodes_tsv,
    write_match_tsv_native,
)

from ..models.matcher import match_segments
from ..observability import stage_scope


def run(args, device=None) -> None:
    """Run the stage; ``device`` as in models.matcher.match_segments."""
    if os.environ.get("SCTAG_CHECKPOINT_DIR"):
        raise NotImplementedError(
            "sctagger_tpu_torch match_trie: checkpointed batches "
            "(SCTAG_CHECKPOINT_DIR) are not ported yet (ROADMAP.md Queue A)"
        )
    if (getattr(args, "n_hosts", 1) or 1) > 1:
        raise NotImplementedError(
            "sctagger_tpu_torch match_trie: --n-hosts > 1 is not ported yet "
            "(ROADMAP.md Queue A)"
        )
    with stage_scope("match_trie") as stats:
        _run(args, stats, device)


def _render_rows(result, names, segs, barcodes) -> str:
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
            f"{names[rid]}\t{result.dists[i]}\t{ties.size}\t"
            f"{segs[rid]}\t{matches}\n"
        )
    return "".join(out)


def _run(args, stats, device) -> None:
    with stats.timer("read"):
        barcodes = read_sr_barcodes_tsv(args.short_read_barcodes)
        print(f"There are {len(barcodes):,} SR barcodes", file=sys.stderr)
        barcode_lens = {len(b) for b in barcodes}
        assert barcode_lens == {args.barcode_length}, barcode_lens
        names, _, _, segs = read_lr_segments_tsv(args.long_read_segments)
        print(f"There are {len(names):,} LRs", file=sys.stderr)
    stats.count("barcodes", len(barcodes))
    stats.count("reads", len(names))

    if args.outfile is not None:
        # fail fast on an unwritable output path BEFORE the expensive match
        open(args.outfile, "wb").close()
    with stats.timer("match"):
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
            wrote = write_match_tsv_native(
                args.outfile, names, segs, barcodes, result
            )
        if not wrote:
            outfile = open_out(args.outfile, force_gzip=False)
            outfile.write(_render_rows(result, names, segs, barcodes))
            if outfile is not sys.stdout:
                outfile.close()
    stats.count("matched", int(result.rids.size))
