#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without enough CUDA devices for the cell, and 3 when a module of
the JAX stack or the JAX package was loaded; neither prints a result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from gpubench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return harness.main(p.parse_args(argv), T0)


if __name__ == "__main__":
    sys.exit(main())
