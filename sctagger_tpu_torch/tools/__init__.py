"""Measurement tools of the port (ports of the JAX package's tools/):

  python -m sctagger_tpu_torch.tools.roofline       int32 ceiling (K7) and
                                                    the K1/K6 shares of it
  python -m sctagger_tpu_torch.tools.profile_match  the match passes (K4, K5,
                                                    K3) at the profile shape

Both need a CUDA device and refuse to run without one: a time measured on
the CPU is not a time of the card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]  # the repository checkout


def require_cuda():
    """The CUDA device, or SystemExit(1) with a message on stderr."""
    import torch

    if not torch.cuda.is_available():
        print("this tool measures the card: torch.cuda.is_available() is false",
              file=sys.stderr)
        raise SystemExit(1)
    return torch.device("cuda")


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up, between two
    CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def make_inputs(n_segs: int, n_barcodes: int = 25_000, seed: int = 0):
    """The flagship workload of the repository's bench.py (24 bp segments
    with planted barcodes): (segments, barcodes)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import bench

    return bench.make_inputs(n_segs, n_barcodes, seed=seed)
