"""CLI of the port: the reference's argument surface (sctagger_tpu.cli
.parse_args, reused), dispatching the subcommands ported so far.

Usage: python -m sctagger_tpu_torch match_trie -lr LR.tsv -sr SR.tsv [...]
"""

from __future__ import annotations

import sys

from sctagger_tpu.cli import parse_args


def main(argv=None):
    args = parse_args(argv)
    if args.subcommand != "match_trie":
        print(
            f"{args.subcommand}: not yet ported to sctagger_tpu_torch "
            "(use python -m sctagger_tpu)",
            file=sys.stderr,
        )
        sys.exit(2)
    print(args)  # the reference echoes its arguments (scTagger.py:849)
    from .stages import match_trie

    match_trie.run(args)


if __name__ == "__main__":
    main()
