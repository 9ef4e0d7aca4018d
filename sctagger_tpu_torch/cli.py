"""CLI of the port: the reference's argument surface (``parse_args`` and
``parse_range_strings``, copied from sctagger_tpu/cli.py), dispatching the
four subcommands and the pipeline runner.

Usage: python -m sctagger_tpu_torch extract_lr_bc -r READS.fq [...]
       python -m sctagger_tpu_torch extract_sr_bc -i SR.bam [...]
       python -m sctagger_tpu_torch extract_sr_bc_from_lr -i LR.tsv.gz -wl WL.txt.gz [...]
       python -m sctagger_tpu_torch match_trie -lr LR.tsv -sr SR.tsv [...]
       python -m sctagger_tpu_torch pipeline -c config.yaml [--from-lr-only]

Each subcommand takes --n-hosts N --host-id H [--sync-dir D]
[--coordinator host:port] for a multi-host run (parallel/multihost.py).
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="scTagger pipeline (TPU-native engine)"
    )
    subparsers = parser.add_subparsers(dest="subcommand")
    subparsers.required = True

    p_lr = subparsers.add_parser("extract_lr_bc")
    p_lr.add_argument("-r", "--reads", nargs="+", type=str, required=True,
                      help="Space separated paths to reads in FASTQ")
    p_lr.add_argument("-g", "--ranges", nargs="+", type=str, default=list(),
                      help="Ranges where the SR adapter should be found on the LRs, "
                           "e.g. f20:40 r1:30 (1-indexed, inclusive; f=forward "
                           "strand side, r=from the read end on reverse strand). "
                           "Default: detect from data.")
    p_lr.add_argument("-z", "--gzipped", dest="gzipped", action="store_true",
                      help="Indicate input is gzipped. Default: assume gzipped "
                           "if it ends with \".gz\".")
    p_lr.add_argument("-t", "--threads", default=1, type=int,
                      help="Number of threads. Default: 1")
    p_lr.add_argument("-sa", "--short-read-adapter", type=str,
                      default="CTACACGACGCTCTTCCGATCT",
                      help="Short-read adapter. Default: CTACACGACGCTCTTCCGATCT")
    p_lr.add_argument("-o", "--outfile", type=str, default=None,
                      help="Path to output file (gzipped). Default: stdout")
    p_lr.add_argument("-p", "--plotfile", type=str, default=None,
                      help="Path to plot file. Default: no plotting")
    p_lr.add_argument("--num-bp-after", type=int, default=20,
                      help="Number of bases after the end of the SR adapter "
                           "alignment to generate. Default: 20")

    p_sr = subparsers.add_parser("extract_sr_bc")
    p_sr.add_argument("-i", "--input", type=str, required=True,
                      help="Input BAM file")
    p_sr.add_argument("-o", "--outfile", type=str, default=None,
                      help="Path to output file. Default: STDOUT")
    p_sr.add_argument("-p", "--plotfile", type=str, default=None,
                      help="Path to plot file")
    p_sr.add_argument("-t", "--threads", default=1, type=int,
                      help="Number of threads. Default: 1")
    p_sr.add_argument("--thresh", type=float, default=0.005,
                      help="Percentage threshold required per step to continue "
                           "adding read barcodes. Default: 0.005")
    p_sr.add_argument("--step-size", type=int, default=1000,
                      help="Number of barcodes processed at a time. Default: 1000")
    p_sr.add_argument("--max-barcode-cnt", type=int, default=25_000,
                      help="Max number of barcodes to keep. Default: 25000")

    p_fl = subparsers.add_parser("extract_sr_bc_from_lr")
    p_fl.add_argument("-i", "--input", type=str, required=True,
                      help="Input TSV file generated from extract_lr_bc step")
    p_fl.add_argument("-o", "--outfile", type=str, default=None,
                      help="Path to output file. Default: STDOUT")
    p_fl.add_argument("-wl", "--barcode-whitelist", type=str, required=True,
                      help="Path to TXT barcode whitelist (e.g. 10x "
                           "3M-february-2018.txt.gz)")
    p_fl.add_argument("--thresh", type=float, default=0.005,
                      help="Percentage threshold required per step to continue "
                           "adding read barcodes. Default: 0.005")
    p_fl.add_argument("--step-size", type=int, default=1000,
                      help="Number of barcodes processed at a time. Default: 1000")
    p_fl.add_argument("--max-barcode-cnt", type=int, default=25_000,
                      help="Max number of barcodes to keep. Default: 25000")

    p_mt = subparsers.add_parser("match_trie")
    p_mt.add_argument("-lr", "--long-read-segments", type=str, required=True,
                      help="Long-read segments TSV file")
    p_mt.add_argument("-sr", "--short-read-barcodes", type=str, required=True,
                      help="Short-read barcode list TSV file")
    p_mt.add_argument("-mr", "--max-error", default=2, type=int,
                      help="Maximum number of errors allowed for barcode "
                           "matching. Default: 2")
    p_mt.add_argument("-m", "--mem", default=16.0, type=float,
                      help="Maximum number of GB of RAM to be used. Default: 16.0 "
                           "(accepted for compatibility; unused)")
    p_mt.add_argument("-bl", "--barcode-length", default=16, type=int,
                      help="Length of barcodes. Default: 16")
    p_mt.add_argument("-t", "--threads", default=16, type=int,
                      help="Number of threads. Default: 16")
    p_mt.add_argument("-p", "--plotfile", default=None, type=str,
                      help="Path of plot file. Default: no plotting "
                           "(accepted for compatibility; unused, as in the "
                           "reference)")
    p_mt.add_argument("-o", "--outfile", type=str, default=None,
                      help="Path to output file. Default: stdout")

    # Additive multi-host surface (not in the reference): shard the input
    # records over N cooperating hosts; host 0 merges byte-identical output.
    for sub in (p_lr, p_sr, p_fl, p_mt):
        g = sub.add_argument_group("multi-host (additive)")
        g.add_argument("--n-hosts", type=int, default=1,
                       help="Total cooperating hosts. Default: 1")
        g.add_argument("--host-id", type=int, default=0,
                       help="This host's id in [0, n-hosts). Default: 0")
        g.add_argument("--sync-dir", type=str, default=None,
                       help="Shared dir for cross-host exchange. Default: "
                            "derived from the outfile + a job content key")
        g.add_argument("--coordinator", type=str, default=None,
                       help="torch.distributed (gloo) rendezvous address "
                            "host:port, host 0 listening; when set, "
                            "reductions ride gloo collectives instead of the "
                            "shared filesystem")

    # Additive surface (not in the reference): the Snakefile-equivalent runner.
    p_pl = subparsers.add_parser("pipeline")
    p_pl.add_argument("-c", "--config", type=str, default="config.yaml",
                      help="Sample-sheet YAML (reference config.yaml schema). "
                           "Default: config.yaml")
    p_pl.add_argument("-s", "--samples", nargs="*", type=str, default=None,
                      help="Subset of samples to run. Default: all")
    p_pl.add_argument("-t", "--threads", default=32, type=int,
                      help="Host threads for external tools. Default: 32")
    p_pl.add_argument("--from-lr-only", action="store_true",
                      help="Skip the cellranger/BAM branch; run only the "
                           "LR-derived whitelist path")

    args = parser.parse_args(argv)

    if args.subcommand == "extract_lr_bc":
        assert 0 < args.num_bp_after
        args.ranges = parse_range_strings(args.ranges)
        assert args.threads > 0

    if args.subcommand in ("extract_sr_bc", "extract_sr_bc_from_lr"):
        assert 0 <= args.thresh <= 1
        assert 0 < args.step_size
        assert 0 < args.max_barcode_cnt

    if args.subcommand == "match_trie":
        assert args.mem > 0
        assert args.barcode_length > 0
        assert args.barcode_length > args.max_error >= 0

    if getattr(args, "n_hosts", 1) != 1:
        assert args.n_hosts > 0, args.n_hosts
        assert 0 <= args.host_id < args.n_hosts, (args.host_id, args.n_hosts)
        assert args.outfile is not None, "--n-hosts > 1 requires -o"

    return args


def parse_range_strings(range_strs):
    """'f20:40' / 'r1:30' -> [forward_ranges, reverse_ranges] as (s, e) pairs.

    Forward 'fS:E' (1-indexed inclusive) -> (S-1, E); reverse 'rS:E' (from
    read end) -> (-E, -S+1). Overlap between preset ranges is rejected.
    NOTE (reference quirk, scTagger.py:122 vs :261): PRESET ranges treat
    position e as a member (arange(s, e+1)); auto-detected ranges use
    arange(s, e) — exclusive. This distinction lives in core/ranges.py.
    """
    ranges = [list(), list()]
    seen = [dict(), dict()]
    for r in range_strs:
        assert r[0] in "fr", r
        strand = r[0]
        parts = r[1:].split(":")
        assert len(parts) == 2, parts
        s, e = int(parts[0]), int(parts[1])
        assert 0 < s <= e, (s, e)
        idx = 0 if strand == "f" else 1
        if strand == "f":
            s, e = s - 1, e
        else:
            s, e = -e, -s + 1
        for i in np.arange(s, e + 1):
            assert i not in seen[idx], (idx, i, seen[idx])
            seen[idx][i] = len(ranges[idx])
        ranges[idx].append((s, e))
    return ranges


def main(argv=None):
    args = parse_args(argv)
    print(args)  # the reference echoes its arguments (scTagger.py:849)
    if getattr(args, "coordinator", None) and getattr(args, "n_hosts", 1) > 1:
        # one gloo rank per host for the stage's reductions, closed after it
        from .parallel.multihost import close_gloo, init_gloo

        init_gloo(args.coordinator, args.host_id, args.n_hosts)
        try:
            _dispatch(args)
        finally:
            close_gloo()
        return
    _dispatch(args)


def _dispatch(args) -> None:
    if args.subcommand == "extract_lr_bc":
        from .stages import extract_lr_bc

        extract_lr_bc.run(args)
    elif args.subcommand == "extract_sr_bc":
        from .stages import extract_sr_bc

        extract_sr_bc.run(args)
    elif args.subcommand == "extract_sr_bc_from_lr":
        from .stages import extract_sr_bc_from_lr

        extract_sr_bc_from_lr.run(args)
    elif args.subcommand == "match_trie":
        from .stages import match_trie

        match_trie.run(args)
    else:
        from .pipeline import run_pipeline

        run_pipeline(
            args.config,
            samples=args.samples,
            threads=args.threads,
            from_lr_only=args.from_lr_only,
        )


if __name__ == "__main__":
    main()
