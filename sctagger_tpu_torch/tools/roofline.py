"""The card's measured int32 ceiling and its published issue rate, and the
match and adapter kernels' shares of both (port of tools/roofline.py).

    python -m sctagger_tpu_torch.tools.roofline [--out PATH]

1. **Ceiling** (K7, csrc/myers_micro.cu): N independent copies of the
   Myers carry chain per element, 21 source ops an iteration, no memory
   traffic but one load and one store per element, at the JAX tool's block
   shape (bp_c = max(8, 256 // N) x 1,024 elements, so every N runs the same
   number of ops) for N in {1, 2, 4, 8}. The ceiling is the best rate over N.
2. **K1** (match_full, csrc/match_full.cu) at the flagship shape of the JAX
   tool's measure_match_kernel: 131,072 segments x 50,176 padded patterns x
   32 positions (bench.make_inputs, bl 16).
3. **K6** (adapter_scan's SLOTS entry, csrc/adapter_scan.cu) on realistic
   chunks: 16,384 and 131,072 (the main path's largest chunk) length-sorted
   reads of 1,000-3,000 bp with the 22 bp adapter at 0-19 under 5%
   substitutions (the reads chip_smoke.py times K6 on), at the default
   segment count.

``measure_mask`` (chip_smoke.py's phase 3b') times K6's MASK entry on the
same reads with ~2% of their chars turned to N (junk), as the mask fallback
sends them: 102 (its launch on the stage-1 main path), 4,096 (its largest
launch) and one empty read (the launch floor).

Each rate is source ops per second under one counting rule, the one the
microkernel's 21 ops follow: one op per C integer operator (arithmetic,
bitwise, shift, compare, min, select) in the loop body, loop control and
address arithmetic not counted, an op shared by several cells divided among
them. The counts, from the CUDA loop bodies:

  K1, per (read, pattern, position) cell: the Myers step 21 (xv 1, xh 4,
  ph 3, mh 1, score 6: two shifts, two masks, a subtract and an add; two
  shifts, pv 3, mv 1), the running min 1, the code clamp 1 shared by the
  PB = 4 patterns of a sweep: 22.25.
  K6, per (read, char, strand), the work of the PR 2 loop body, kept as the
  yardstick of the same function: the Myers step 21, the Eq select 3 (plus
  its two code-bit tests, shared by both strands: 1), the 2-bit unpack (mask
  and shift, shared by both strands: 1), the compares against the running
  min 2 (their bodies run only on a new min or a tie): 28. (The segment
  warm-up the kernel adds is not counted: it is not work the function
  needs.)
  K6 MASK, per (read, char, strand): the Myers step 21, the Eq of the
  char's code 1 (a table lookup; junk codes look up zero), the running min
  1, the compare with the min that marks the position 1: 24.

nvcc fuses logical ops into LOP3 and adds into IADD3, so a source-op rate
can exceed the card's INT32 instruction rate; the shares compare kernels
counted the same way. Where cuobjdump is found, each kernel's innermost loop
is also counted in SASS instructions (per trip of the compiled loop, divided
by the cells a trip covers: K1-K5 and both K6 entries, and K7 at each chain
count) and the shares are given in instructions too. K6 SLOTS's loop holds
its bookkeeping behind a branch, so its whole loop is an upper bound on
what a cell runs; the path that skips every forward branch of the loop (the
bookkeeping and the word select), a lower bound, is given beside it as
``sass_hot_per_cell``.

Beside the measured ceiling stands the published one: the card's issue
rate, one warp instruction (32 lanes) per clock from each of the 4
schedulers of every SM (NVIDIA's H100 architecture white paper), at the
maximum SM clock that nvidia-smi reports (``clocks.max.sm``): 132 x 4 x 32
x 1,980 MHz = 33.45 T lane-instructions/s on an H100 SXM. The SM clock is
also read while K7 runs (``clocks.sm``). A kernel's ``issue_share`` counts
the instructions the function needs, not the ones its code spends:
``issue_per_cell``, the fewer of its source ops and its compiled loop's
hot path per cell (the whole loop where it has no branch), so neither a
branch the hot path skips nor an instruction beyond the source's work
raises a share. K7's are counted the same way per chain-iteration.

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
import time

import numpy as np
import torch

from ..core.packing import LENIENT_TABLE, encode_rows, encode_seqs, encode_str, rev_compl

from ..models.matcher import MatchContext
from ..ops import _build
from ..ops import adapter_cuda as ac
from ..ops import match_cuda as mc
from ..ops import micro_cuda
from ..ops.myers import build_peq_multi
from . import cuda_ms, device_ms, gpu_line, make_inputs, require_cuda

MATCH_OPS_PER_CELL = 22.25
ADAPTER_OPS_PER_CHAR_STRAND = 28.0
MASK_OPS_PER_CHAR_STRAND = 24.0  # Myers 21, Eq lookup 1, min 1, == min 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
MICRO_BP, MICRO_BR = 256, 1024  # the JAX tool's block; bp_c = MICRO_BP // chains
MICRO_ITERS, MICRO_GRID = 1024, 64
MATCH_SEGS, MATCH_LS, MATCH_BL = 131_072, 32, 16
ADAPTER = "CTACACGACGCTCTTCCGATCT"
ADAPTER_READS = (16_384, 131_072)
MASK_READS = {"main": 102, "full": 4096, "floor": 0}  # 0: one empty read

LANES_PER_SM_CLOCK = 4 * 32  # lane-instructions an SM issues a clock: 4
#                              schedulers x one warp instruction of 32 lanes

# cells one trip of each kernel's innermost compiled loop covers
MATCH_CELLS_PER_TRIP = 2 * 4  # `#pragma unroll 2` positions x PB patterns
ADAPTER_CELLS_PER_TRIP = 16 * 2  # 16 chars of a packed word x 2 strands
MASK_CELLS_PER_TRIP = 32  # one 32-char mask word of one strand (a thread's)
CELLS_PER_TRIP = {
    "match_full": MATCH_CELLS_PER_TRIP, "match_full_dynls": MATCH_CELLS_PER_TRIP,
    "match_min": MATCH_CELLS_PER_TRIP, "match_best": MATCH_CELLS_PER_TRIP,
    "match_ties": MATCH_CELLS_PER_TRIP, "adapter_scan": ADAPTER_CELLS_PER_TRIP,
    "adapter_mask": MASK_CELLS_PER_TRIP,
}
# mangled-name pattern of each kernel, by library; the match epilogues are
# match_sweep<DYN, EPI> (EPI: 0 FULL, 1 MIN, 2 BEST, 3 TIES)
SASS_KERNELS = {
    "match_full": ("match_full", r"match_sweepILb0ELi0E"),
    "match_full_dynls": ("match_full", r"match_sweepILb1ELi0E"),
    "match_min": ("match_full", r"match_sweepILb0ELi1E"),
    "match_best": ("match_full", r"match_sweepILb0ELi2E"),
    "match_ties": ("match_full", r"match_sweepILb0ELi3E"),
    "adapter_scan": ("adapter_scan", r"adapter_slots"),
    "adapter_mask": ("adapter_scan", r"adapter_mask"),
    **{f"micro_{c}": ("myers_micro", rf"myers_microILi{c}E") for c in micro_cuda.CHAINS},
}
HOT_PATHS = ("adapter_scan",)  # loops whose bookkeeping branches


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


def innermost_loop(instrs: list[tuple[int, str]], hot: bool = False) -> int | None:
    """Instructions (NOPs excluded) of the largest innermost loop: a loop is
    a backward branch and the range it jumps over; innermost holds no other
    loop. ``hot``: only those no predicated forward branch of the loop
    jumps over (the path on which every such branch is taken)."""
    loops = []
    for addr, ins in instrs:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(?:`?\(?)(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [
        lp for lp in loops
        if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)
    ]
    sizes = []
    for lo, hi in inner:
        body = [(a, ins) for a, ins in instrs if lo <= a <= hi and not ins.startswith("NOP")]
        skips = []
        for a, ins in body if hot else ():
            m = re.search(r"^@!?U?P\S*\s+BRA(?:\.\S+)?\s+(?:\S+,\s*)?`?\(?(0x[0-9a-f]+)", ins)
            if m and a < int(m.group(1), 16) <= hi:
                skips.append((a, int(m.group(1), 16)))
        sizes.append(sum(1 for a, _ in body if not any(s < a < t for s, t in skips)))
    return max(sizes) if sizes else None


def sass_loop_sizes() -> dict[str, int | None] | None:
    """Innermost-loop SASS instruction counts of every kernel in
    SASS_KERNELS (K1-K5, K6 SLOTS and MASK, K7 at each chain count), with
    the hot path of each loop in HOT_PATHS as ``<name>_hot``; None without
    cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    libs = _build.build()
    sass = {}
    for lib in {lib for lib, _ in SASS_KERNELS.values()}:
        out = subprocess.run([tool, "-sass", str(libs[lib])], capture_output=True,
                             text=True, check=True)
        sass[lib] = parse_sass(out.stdout)
    res = {}
    for key, (lib, pat) in SASS_KERNELS.items():
        names = [n for n in sass[lib] if re.search(pat, n)]
        res[key] = innermost_loop(sass[lib][names[0]]) if len(names) == 1 else None
        if key in HOT_PATHS:
            res[f"{key}_hot"] = (innermost_loop(sass[lib][names[0]], hot=True)
                                 if len(names) == 1 else None)
    return res


def sass_per_cell(sass: dict, name: str) -> float | None:
    """SASS instructions per cell of kernel ``name`` (a key of
    CELLS_PER_TRIP): its whole innermost loop over the cells a trip covers."""
    n = sass.get(name)
    return None if n is None else n / CELLS_PER_TRIP[name]


def issue_per_cell(sass: dict, name: str, ops_per_cell: float) -> float | None:
    """Instructions per cell that kernel ``name``'s function needs: the
    fewer of its source ops and its loop's hot path per cell (the whole
    loop where HOT_PATHS has no hot path for it)."""
    n = sass.get(f"{name}_hot", sass.get(name))
    return None if n is None else min(ops_per_cell, n / CELLS_PER_TRIP[name])


# ---------------------------------------------------------------------------
# The published issue rate
# ---------------------------------------------------------------------------

def issue_rate(sms: int, mhz: float) -> float:
    """Lane-instructions per second the card can issue: ``sms`` SMs x 4
    schedulers x 32 lanes x the SM clock in MHz."""
    return sms * LANES_PER_SM_CLOCK * mhz * 1e6


def issue_bound_ms(sass: float, sms: int, mhz: float) -> float:
    """The least time in ms for ``sass`` lane-instructions at the issue rate."""
    return 1e3 * sass / issue_rate(sms, mhz)


def parse_clocks(line: str) -> dict:
    """One line of ``nvidia-smi --query-gpu=name,power.limit,clocks.sm,
    clocks.max.sm --format=csv,noheader`` -> the card's name and power limit
    (as ``gpu_line`` gives them) and both SM clocks in MHz."""
    name, power, sm, max_sm = (f.strip() for f in line.strip().rsplit(",", 3))

    def mhz(f: str) -> int:
        return int(f.split()[0])

    return {"gpu": f"{name}, {power}", "sm_mhz": mhz(sm), "max_sm_mhz": mhz(max_sm)}


def gpu_clocks() -> dict:
    """``parse_clocks`` of the first card, read now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return parse_clocks(out.stdout.splitlines()[0])


def clocks_under(fn, calls: int) -> dict:
    """``gpu_clocks`` read while ``calls`` launches of ``fn`` run: they are
    enqueued first, the clocks read while the card works through them."""
    for _ in range(calls):
        fn()
    clk = gpu_clocks()
    torch.cuda.synchronize()
    return clk


# ---------------------------------------------------------------------------
# Measurements
# ---------------------------------------------------------------------------

def measure_ceiling(dev, iters: int = MICRO_ITERS, grid: int = MICRO_GRID,
                    reps: int = 3) -> dict:
    """Source ops/s of K7 at each chain count, and the best of them; the SM
    clock read while the best chain count runs (~1 s of launches)."""
    by_chains = {}
    for chains in micro_cuda.CHAINS:
        x = micro_cuda.micro_input(max(8, MICRO_BP // chains), MICRO_BR).to(dev)
        ms = cuda_ms(lambda: micro_cuda.micro(x, iters, chains, grid), reps)
        ops = micro_cuda.micro_ops(x.numel(), iters, chains, grid)
        by_chains[chains] = {"elements": x.numel(), "ms": ms,
                             "ops_per_s": ops / (ms * 1e-3)}
    best = max(by_chains, key=lambda c: by_chains[c]["ops_per_s"])
    x = micro_cuda.micro_input(max(8, MICRO_BP // best), MICRO_BR).to(dev)
    calls = max(1, int(1000 / by_chains[best]["ms"]))
    clocks = clocks_under(lambda: micro_cuda.micro(x, iters, best, grid), calls)
    return {"iters": iters, "grid": grid, "by_chains": by_chains, "best_chains": best,
            "ops_per_s": by_chains[best]["ops_per_s"], "clocks": clocks}


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


def adapter_reads(n: int, seed: int = 3) -> list[str]:
    """``n`` reads of 1,000-3,000 bp with the 22 bp adapter at 0-19 under
    5% substitutions, sorted by length (stable)."""
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
    return sorted(reads, key=len)


def add_junk(rng, reads: list[str], p: float = 0.02) -> list[str]:
    """Each read with about a fraction ``p`` of its chars turned to N."""
    out = []
    for r in reads:
        b = np.frombuffer(r.encode(), np.uint8).copy()
        b[rng.random(b.size) < p] = ord("N")
        out.append(b.tobytes().decode())
    return out


def _peq(adapter: str) -> np.ndarray:
    return ac.prep_peq(build_peq_multi(np.stack([encode_str(adapter),
                                                encode_str(rev_compl(adapter))])))


def adapter_chunk(dev, seed: int = 3, n: int = ADAPTER_READS[0]):
    """One realistic K6 chunk of ``adapter_reads`` on ``dev``: (text, lens,
    peq, m)."""
    reads = adapter_reads(n, seed)
    text, ln, junk = ac.pack_chunk(reads, np.arange(n), len(reads[-1]))
    assert not junk.any()
    return (torch.from_numpy(text).to(dev), torch.from_numpy(ln).to(dev), _peq(ADAPTER),
            len(ADAPTER))


def mask_rows(reads: list[str], dev, adapter: str = ADAPTER):
    """The byte codes of ``reads`` on ``dev``, as the mask fallback builds
    them (rows of a multiple of 32 bytes): (codes, lens, peq, m)."""
    L = -(-max(1, max(map(len, reads))) // 32) * 32
    codes, lens = encode_rows(reads, np.arange(len(reads)), pad_to=L)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev), _peq(adapter),
            len(adapter))


def measure_adapter(dev, n: int, reps: int = 20) -> dict:
    """K6 SLOTS on the realistic chunk of ``n`` reads: (read, char, strand)
    cells per second."""
    args = adapter_chunk(dev, n=n)
    ms = cuda_ms(lambda: ac.adapter_scan(*args), reps)
    cells = 2 * int(args[1].sum())
    return {"reads": int(args[1].numel()), "chars": cells // 2, "ms": ms,
            "cells_per_s": cells / (ms * 1e-3),
            "ops_per_cell": ADAPTER_OPS_PER_CHAR_STRAND}


def measure_mask(dev, seed: int = 5, sweep: bool = False) -> dict:
    """K6 MASK at each shape of MASK_READS on ``add_junk(adapter_reads)``:
    per shape its reads, row length, chars, bytes (inputs read and outputs
    written once), ``ms`` (``cuda_ms``, per call on an idle card, the
    host's launch cost included), ``device_ms`` (launches queued back to
    back), the plain version's ``plain_ms`` and ``max_abs_err`` (raises
    unless 0). With ``sweep``, ``device_ms`` at each forced segment count
    as ``device_ms_by_nseg``."""
    rng = np.random.default_rng(seed)
    res = {}
    for tag, n in MASK_READS.items():
        args = mask_rows(add_junk(rng, adapter_reads(n, seed)) if n else [""], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ac.adapter_mask_ref(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got = ac.adapter_mask(*args)
        err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
        if err:
            raise AssertionError(f"MASK differs from adapter_mask_ref ({tag}, {n} reads)")
        res[tag] = {
            "reads": int(args[1].numel()), "row_len": args[0].shape[1],
            "chars": int(args[1].sum()), "nseg": ac.mask_nseg_for(*args[0].shape),
            "bytes": sum(t.numel() * t.element_size() for t in (args[0], args[1], *got)),
            "ms": cuda_ms(lambda: ac.adapter_mask(*args), reps=20),
            "device_ms": device_ms(lambda: ac.adapter_mask(*args), reps=50),
            "plain_ms": plain_ms, "max_abs_err": err,
        }
        if sweep and n:
            res[tag]["device_ms_by_nseg"] = {
                k: device_ms(lambda: ac.adapter_mask(*args, nseg=k), reps=50)
                for k in (1, 2, 4, 8, 16, 32)}
    return res


def add_sass_rates(ceiling: dict, kernels: dict, sass: dict,
                   issue: float | None = None) -> None:
    """Adds the SASS rates to ``ceiling`` (per chain count, and the best as
    ``sass_per_s``) and to each kernel: ``sass_per_cell`` (the whole loop),
    its rate and share of the SASS ceiling, and ``sass_hot_per_cell`` where
    the loop has a hot path. Given the issue rate ``issue`` (lane-
    instructions/s), K7 at each chain count, the best of them and each
    kernel get an ``issue_share``: the instructions the function needs
    (``issue_per_cell``; K7's the fewer of its 21 ops and its loop per
    chain-iteration) at the measured rate over ``issue``."""
    per_iter = {}
    for c, v in ceiling["by_chains"].items():
        n = sass.get(f"micro_{c}")
        if n is not None:  # one trip = one iteration of every chain
            iters_per_s = v["ops_per_s"] / micro_cuda.OPS_PER_ITER
            v["sass_per_chain_iter"] = n / c
            v["sass_per_s"] = iters_per_s * n / c
            per_iter[c] = v["sass_per_s"]
            if issue:
                v["issue_share"] = iters_per_s * min(micro_cuda.OPS_PER_ITER, n / c) / issue
    ceiling["sass_per_s"] = max(per_iter.values()) if per_iter else None
    if issue and per_iter:
        ceiling["issue_share"] = max(ceiling["by_chains"][c]["issue_share"] for c in per_iter)
    for name, k in kernels.items():
        base = name.split("@")[0]
        per_cell = sass_per_cell(sass, base)
        if per_cell is None or not ceiling["sass_per_s"]:
            continue
        k["sass_per_cell"] = per_cell
        k["sass_per_s"] = k["cells_per_s"] * per_cell
        k["sass_share_of_ceiling"] = k["sass_per_s"] / ceiling["sass_per_s"]
        hot = sass.get(f"{base}_hot")
        if hot is not None:
            k["sass_hot_per_cell"] = hot / CELLS_PER_TRIP[base]
        if issue:
            k["issue_per_cell"] = issue_per_cell(sass, base, k["ops_per_cell"])
            k["issue_share"] = k["cells_per_s"] * k["issue_per_cell"] / issue


def run(dev, reps: int = 3) -> dict:
    """All three measurements and the shares; returns the JSON object."""
    ceiling = measure_ceiling(dev, reps=reps)
    kernels = {"match_full": measure_match(dev, reps)}
    for n in ADAPTER_READS:
        kernels["adapter_scan" if n == ADAPTER_READS[0] else f"adapter_scan@{n}"] = \
            measure_adapter(dev, n)
    for k in kernels.values():
        k["ops_per_s"] = k["cells_per_s"] * k["ops_per_cell"]
        k["share_of_ceiling"] = k["ops_per_s"] / ceiling["ops_per_s"]
    clk = ceiling["clocks"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    issue = {"sms": sms, "max_sm_mhz": clk["max_sm_mhz"], "sm_mhz_under_k7": clk["sm_mhz"],
             "lanes_per_s": issue_rate(sms, clk["max_sm_mhz"]),
             "rule": "SMs x 4 schedulers x 32 lanes x clocks.max.sm"}
    sass = sass_loop_sizes()
    if sass is None:
        sass_note = "not measured (no cuobjdump)"
    else:
        sass_note = ("SASS instructions of the innermost compiled loop per "
                     "cell it covers; rates in instructions/s")
        add_sass_rates(ceiling, kernels, sass, issue["lanes_per_s"])
    return {
        "device": torch.cuda.get_device_name(dev),
        "gpu": gpu_line(),
        "issue": issue,
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
