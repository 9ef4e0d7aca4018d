"""The card's measured int32 ceiling and the match and adapter kernels'
shares of it (port of tools/roofline.py).

    python -m sctagger_tpu_torch.tools.roofline [--out PATH]

1. **Ceiling** (K7, csrc/myers_micro.cu): N independent copies of the
   Myers carry chain per element, 21 source ops an iteration, no memory
   traffic but one load and one store per element, at the JAX tool's block
   shape (bp_c = max(8, 256 // N) x 1,024 elements, so every N runs the same
   number of ops) for N in {1, 2, 4, 8}. The ceiling is the best rate over N.
2. **K1** (match_full, csrc/match_full.cu) at the flagship shape of the JAX
   tool's measure_match_kernel: 131,072 segments x 50,176 padded patterns x
   32 positions (bench.make_inputs, bl 16).
3. **K6** (adapter_scan, csrc/adapter_scan.cu) on a realistic chunk: 16,384
   length-sorted reads of 1,000-3,000 bp with the 22 bp adapter at 0-19
   under 5% substitutions (the reads chip_smoke.py times K6 on).

Each rate is source ops per second under one counting rule, the one the
microkernel's 21 ops follow: one op per C integer operator (arithmetic,
bitwise, shift, compare, min, select) in the loop body, loop control and
address arithmetic not counted, an op shared by several cells divided among
them. The counts, from the CUDA loop bodies:

  K1, per (read, pattern, position) cell: the Myers step 21 (xv 1, xh 4,
  ph 3, mh 1, score 6: two shifts, two masks, a subtract and an add; two
  shifts, pv 3, mv 1), the running min 1, the code clamp 1 shared by the
  PB = 4 patterns of a sweep: 22.25.
  K6, per (read, char, strand): the Myers step 21, the Eq select 3 (plus its
  two code-bit tests, shared by both strands: 1), the 2-bit unpack (mask and
  shift, shared by both strands: 1), the compares against the running min 2
  (their bodies run only on a new min or a tie): 28.

nvcc fuses logical ops into LOP3 and adds into IADD3, so a source-op rate
can exceed the card's INT32 instruction rate; the shares compare kernels
counted the same way. Where cuobjdump is found, each kernel's innermost loop
is also counted in SASS instructions (per trip of the compiled loop, divided
by the cells a trip covers) and the shares are given in instructions too.

Prints one JSON object; ``--out PATH`` also writes it to PATH (it never
writes anywhere else). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess

import numpy as np
import torch

from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs, encode_str, rev_compl

from ..models.matcher import MatchContext
from ..ops import _build
from ..ops import adapter_cuda as ac
from ..ops import match_cuda as mc
from ..ops import micro_cuda
from ..ops.myers import build_peq_multi
from . import cuda_ms, gpu_line, make_inputs, require_cuda

MATCH_OPS_PER_CELL = 22.25
ADAPTER_OPS_PER_CHAR_STRAND = 28.0
MICRO_BP, MICRO_BR = 256, 1024  # the JAX tool's block; bp_c = MICRO_BP // chains
MICRO_ITERS, MICRO_GRID = 1024, 64
MATCH_SEGS, MATCH_LS, MATCH_BL = 131_072, 32, 16
ADAPTER = "CTACACGACGCTCTTCCGATCT"
ADAPTER_READS = 16_384

# cells one trip of each kernel's innermost compiled loop covers
MATCH_CELLS_PER_TRIP = 2 * 4  # `#pragma unroll 2` positions x PB patterns
ADAPTER_CELLS_PER_TRIP = 16 * 2  # 16 chars of a packed word x 2 strands


# ---------------------------------------------------------------------------
# SASS of the innermost loops
# ---------------------------------------------------------------------------

def _cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/cuobjdump")
    return str(cand) if cand.exists() else None


def parse_sass(text: str) -> dict[str, list[tuple[int, str]]]:
    """cuobjdump -sass output -> {function name: [(address, instruction)]}."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def innermost_loop(instrs: list[tuple[int, str]]) -> int | None:
    """Instructions (NOPs excluded) of the largest innermost loop: a loop is
    a backward branch and the range it jumps over; innermost holds no other
    loop."""
    loops = []
    for addr, ins in instrs:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(?:`?\(?)(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [
        lp for lp in loops
        if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)
    ]
    sizes = [
        sum(1 for a, ins in instrs if lo <= a <= hi and not ins.startswith("NOP"))
        for lo, hi in inner
    ]
    return max(sizes) if sizes else None


def sass_loop_sizes() -> dict[str, int | None] | None:
    """Innermost-loop SASS instruction counts of K1 (match_full, no bound),
    K6 and K7 at each chain count; None without cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    libs = _build.build()
    wanted = {
        "match_full": ("match_full", r"match_sweepILb0ELi0E"),
        "adapter_scan": ("adapter_scan", r"adapter_scan"),
        **{f"micro_{c}": ("myers_micro", rf"myers_microILi{c}E") for c in micro_cuda.CHAINS},
    }
    sass = {}
    for lib in {lib for lib, _ in wanted.values()}:
        out = subprocess.run([tool, "-sass", str(libs[lib])], capture_output=True,
                             text=True, check=True)
        sass[lib] = parse_sass(out.stdout)
    res = {}
    for key, (lib, pat) in wanted.items():
        names = [n for n in sass[lib] if re.search(pat, n)]
        res[key] = innermost_loop(sass[lib][names[0]]) if len(names) == 1 else None
    return res


# ---------------------------------------------------------------------------
# Measurements
# ---------------------------------------------------------------------------

def measure_ceiling(dev, iters: int = MICRO_ITERS, grid: int = MICRO_GRID,
                    reps: int = 3) -> dict:
    """Source ops/s of K7 at each chain count, and the best of them."""
    by_chains = {}
    for chains in micro_cuda.CHAINS:
        x = micro_cuda.micro_input(max(8, MICRO_BP // chains), MICRO_BR).to(dev)
        ms = cuda_ms(lambda: micro_cuda.micro(x, iters, chains, grid), reps)
        ops = micro_cuda.micro_ops(x.numel(), iters, chains, grid)
        by_chains[chains] = {"elements": x.numel(), "ms": ms,
                             "ops_per_s": ops / (ms * 1e-3)}
    best = max(by_chains.values(), key=lambda v: v["ops_per_s"])
    return {"iters": iters, "grid": grid, "by_chains": by_chains,
            "ops_per_s": best["ops_per_s"]}


def measure_match(dev, reps: int = 3) -> dict:
    """K1 at the flagship shape: cells (segment x padded pattern x
    position) per second."""
    segs, barcodes = make_inputs(MATCH_SEGS)
    ctx = MatchContext(barcodes)
    peq = torch.from_numpy(mc.prep_peq_cols(ctx.peq())).to(dev)
    codes, _ = encode_seqs(segs, pad_to=MATCH_LS, table=LENIENT_TABLE)
    seg = torch.from_numpy(mc.prep_segs_T(codes, ls=MATCH_LS)).to(dev)
    ms = cuda_ms(lambda: mc.match_full(seg, peq, MATCH_BL), reps)
    cells = MATCH_SEGS * peq.shape[0] * MATCH_LS
    return {"segments": MATCH_SEGS, "padded_patterns": peq.shape[0],
            "positions": MATCH_LS, "ms": ms, "cells_per_s": cells / (ms * 1e-3),
            "ops_per_cell": MATCH_OPS_PER_CELL}


def adapter_chunk(dev, seed: int = 3, n: int = ADAPTER_READS):
    """One realistic K6 chunk on ``dev``: (text, lens, peq, m)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapter = np.frombuffer(ADAPTER.encode(), np.uint8)
    lens = rng.integers(1000, 3000, n)
    body = acgt[rng.integers(0, 4, int(lens.sum()))]
    subs = rng.random((n, adapter.size)) < 0.05
    alt = acgt[rng.integers(0, 4, (n, adapter.size))]
    at = rng.integers(0, 20, n)
    starts = np.concatenate([[0], np.cumsum(lens)])
    reads = []
    for i in range(n):
        t = body[starts[i] : starts[i + 1]]
        a = np.where(subs[i], alt[i], adapter)
        reads.append(np.concatenate([t[: at[i]], a, t[at[i] :]]).tobytes().decode())
    rl = np.array([len(r) for r in reads])
    order = np.argsort(rl, kind="stable")
    text, ln, junk = ac.pack_chunk(reads, order, int(rl.max()))
    assert not junk.any()
    peq = ac.prep_peq(build_peq_multi(np.stack([encode_str(ADAPTER),
                                                encode_str(rev_compl(ADAPTER))])))
    return torch.from_numpy(text).to(dev), torch.from_numpy(ln).to(dev), peq, len(ADAPTER)


def measure_adapter(dev, reps: int = 20) -> dict:
    """K6 on the realistic chunk: (read, char, strand) cells per second."""
    args = adapter_chunk(dev)
    ms = cuda_ms(lambda: ac.adapter_scan(*args), reps)
    cells = 2 * int(args[1].sum())
    return {"reads": int(args[1].numel()), "chars": cells // 2, "ms": ms,
            "cells_per_s": cells / (ms * 1e-3),
            "ops_per_cell": ADAPTER_OPS_PER_CHAR_STRAND}


def run(dev, reps: int = 3) -> dict:
    """All three measurements and the shares; returns the JSON object."""
    ceiling = measure_ceiling(dev, reps=reps)
    kernels = {"match_full": measure_match(dev, reps), "adapter_scan": measure_adapter(dev)}
    for k in kernels.values():
        k["ops_per_s"] = k["cells_per_s"] * k["ops_per_cell"]
        k["share_of_ceiling"] = k["ops_per_s"] / ceiling["ops_per_s"]
    sass = sass_loop_sizes()
    if sass is None:
        sass_note = "not measured (no cuobjdump)"
    else:
        sass_note = ("SASS instructions of the innermost compiled loop per "
                     "cell it covers; rates in instructions/s")
        per_iter = {}
        for c, v in ceiling["by_chains"].items():
            n = sass.get(f"micro_{c}")
            if n is not None:  # one trip = one iteration of every chain
                v["sass_per_chain_iter"] = n / c
                v["sass_per_s"] = v["ops_per_s"] / micro_cuda.OPS_PER_ITER * n / c
                per_iter[c] = v["sass_per_s"]
        ceiling["sass_per_s"] = max(per_iter.values()) if per_iter else None
        trips = {"match_full": MATCH_CELLS_PER_TRIP, "adapter_scan": ADAPTER_CELLS_PER_TRIP}
        for name, k in kernels.items():
            n = sass.get(name)
            if n is None or not ceiling["sass_per_s"]:
                continue
            k["sass_per_cell"] = n / trips[name]
            k["sass_per_s"] = k["cells_per_s"] * k["sass_per_cell"]
            k["sass_share_of_ceiling"] = k["sass_per_s"] / ceiling["sass_per_s"]
    return {
        "device": torch.cuda.get_device_name(dev),
        "gpu": gpu_line(),
        "ceiling": ceiling,
        "kernels": kernels,
        "sass_loops": sass,
        "counting": ("source ops: one per C integer operator in the loop body, "
                     "loop control and addressing excluded; K7 21 per "
                     f"chain-iteration, K1 {MATCH_OPS_PER_CELL} per cell, K6 "
                     f"{ADAPTER_OPS_PER_CHAR_STRAND} per char and strand"),
        "sass": sass_note,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = ap.parse_args(argv)
    dev = require_cuda()
    res = run(dev)
    line = json.dumps(res)
    if args.out is not None:
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
