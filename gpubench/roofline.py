"""The frozen yardstick for the kernels' roofline shares.

A share is the least time the card could take for the work these inputs
need, over the kernel's time in the profiler trace:

    share = cells x ops_per_cell x (m / 32) / LANE_PEAK / kernel_seconds

- Cells are what the function needs: for the match sweep, the reads handed
  to the device x the real patterns (2 x whitelist, padding not counted) x
  each read's length; for the adapter scan (K6 SLOTS), the chars of the
  reads handed to it x 2 strands.
- Ops per cell are the function's source operations, one per C integer
  operator of the bit-parallel Myers step and the running min, counted once
  from the algorithm and written here as constants: 22.25 for a match cell,
  28 for an adapter char and strand.
- A pattern of m bases uses m of a 32-bit lane's bits, so a cell counts
  m/32 of a lane's ops: 16/32 for a barcode, 22/32 for the adapter. A kernel
  that packs patterns into words does less work per cell, and still cannot
  read above 100%.
- LANE_PEAK is the H100's published issue rate: 132 SMs x 4 schedulers x
  32 lanes x 1,980 MHz (NVIDIA's H100 white paper; nvidia-smi's
  clocks.max.sm), 33.454 T lane-instructions per second.

Nothing here reads the program, its compiled code or its microbenchmark.
"""

from __future__ import annotations

SMS, SCHEDULERS, LANES, MAX_SM_HZ = 132, 4, 32, 1.980e9
LANE_PEAK = SMS * SCHEDULERS * LANES * MAX_SM_HZ  # lane-instructions / s
WORD_BITS = 32
MATCH_OPS_PER_CELL = 22.25
ADAPTER_OPS_PER_CHAR_STRAND = 28.0


def lane_share(m: int) -> float:
    """Share of a 32-bit lane a pattern of m bases needs."""
    return min(m, WORD_BITS) / WORD_BITS


def sweep_seconds(reads: float, patterns: int, mean_len: float, m: int) -> float:
    """Least time for the match sweep over ``reads`` reads."""
    return reads * patterns * mean_len * MATCH_OPS_PER_CELL * lane_share(m) / LANE_PEAK


def slots_seconds(chars: float, m: int) -> float:
    """Least time for the adapter scan over ``chars`` chars, both strands."""
    return chars * 2 * ADAPTER_OPS_PER_CHAR_STRAND * lane_share(m) / LANE_PEAK


def share_pct(least_s: float, kernel_s: float) -> float | None:
    """The share in %, or None where the trace holds no kernel time."""
    if not kernel_s or kernel_s <= 0:
        return None
    return 100.0 * least_s / kernel_s
