"""CLI of the port: the reference's argument surface (sctagger_tpu.cli
.parse_args, reused), dispatching the subcommands ported so far.

Usage: python -m sctagger_tpu_torch extract_lr_bc -r READS.fq [...]
       python -m sctagger_tpu_torch match_trie -lr LR.tsv -sr SR.tsv [...]
"""

from __future__ import annotations

import sys

from sctagger_tpu.cli import parse_args

PORTED = ("extract_lr_bc", "match_trie")


def main(argv=None):
    args = parse_args(argv)
    if args.subcommand not in PORTED:
        print(
            f"{args.subcommand}: not yet ported to sctagger_tpu_torch "
            "(use python -m sctagger_tpu)",
            file=sys.stderr,
        )
        sys.exit(2)
    print(args)  # the reference echoes its arguments (scTagger.py:849)
    if args.subcommand == "extract_lr_bc":
        from .stages import extract_lr_bc

        extract_lr_bc.run(args)
    else:
        from .stages import match_trie

        match_trie.run(args)


if __name__ == "__main__":
    main()
