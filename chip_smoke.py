#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sctagger_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--segments N] [--lr-reads N]

Phases, each fatal on failure:
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile csrc/*.cu with nvcc (sm_90a, one nvcc per source, in
     parallel) from this checkout, and the port's host library
     (sctagger_tpu_torch/native, g++) that FASTQ/TSV I/O and the prefilters
     use.
  3. kernel vs plain:
     - the match kernel (match_full / match_full_dynls) against its plain
       torch version on the card, exact equality, at m in {16, 31, 32},
       uniform and ragged lengths, a read with > 8 ties, and one 16,384-read
       x 50,000-pattern chunk of 24 bp segments (timed); then
       match_segments on the card against the CPU with > 8 ties and with
       40 bp barcodes (tie escalation and the multi-word path);
     - the adapter-scan kernel's SLOTS entry (adapter_scan) against
       adapter_scan_ref on the card, exact equality of the full rows, at m
       in {22, 31, 32}, uniform and ragged lengths, empty and shorter-than-m
       reads, reads with > 4 optimal ends and reads of >= 70,000 bp, each at
       the default segment count, at 1 and 32 segments per read and with
       the bookkeeping on every char; then chunks of 300, 16,384 and 131,072
       reads of 1,000-3,000 bp (the last two timed);
     - its MASK entry (adapter_mask) against adapter_mask_ref, exact d and
       mask bits, at m in {22, 31, 32}, with junk, > 4 and > 64 ends, empty
       and shorter-than-m reads and three reads of >= 70,000 bp, at the
       default segment count and at each of 1, 2, 4, 8, 16 and 32 segments
       per read; then length-sorted batches of 102 (the main path's MASK
       launch) and 4,096 (the largest launch) junk reads of 1,000-3,000 bp,
       and one empty read (the launch floor), timed per call and with the
       launches queued (tools.roofline.measure_mask);
     - the min, best-matrix and ties epilogues of the match kernel
       (match_min / match_best / match_ties, K4 / K5 / K3) against their
       plain versions, exact equality, at m in {16, 31, 32}, uniform and
       ragged, a few-read case that splits the pattern axis and merges, a
       one-tile case that does not, ties at K1's minima and at m; then the
       16,384-read x 50,000-pattern chunk (timed);
     - the int32 microkernel (myers_micro, K7) against micro_ref at chains
       1/2/4/8, small and at tools.roofline's ceiling shape (MICRO_ITERS
       iterations, grid MICRO_GRID; the plain version timed there; the
       kernel is timed by tools.roofline).
  4. main paths, each with every launch count set to 0 just before it:
     - `match_trie` through sctagger_tpu_torch.cli.main on the flagship
       workload (bench.make_inputs: N segments x 25,000 barcodes, mr=2);
     - `extract_lr_bc` through sctagger_tpu_torch.cli.main on N long reads
       (tools/measure_reference.make_lr_fastq: 1,000-3,000 bp, the 22 bp
       adapter at 0-19 with 5% substitutions): SLOTS and MASK launched, no
       read through the plain-torch mask path;
     - `entry()` (sctagger_tpu_torch.entry: K4 on the toy problem), its
       output equal to the CPU plain version's;
     - `tools.profile_match` (K4 pass 1 at 131,072 segments, K5 + top-k
       and K3 pass 2);
     - `tools.roofline` (K7 ceiling at chains 1/2/4/8, K1 and K6 at 16,384
       and 131,072 reads read as shares of it; the SASS loop of every kernel;
       the SM clocks and the card's issue rate), whose JSON is printed on a
       [roofline] line; its ceiling sets every kernel's bound_ms, its issue
       rate and SASS counts every issue_bound_ms.
     check_device_paths (phase 3) also requires that the > 8-ties escalation
     at bl 16 launched match_best (K5) on the card; the `match_trie` run
     logs the reads it escalates and K5's launches there.
  5. output checks: the first 1,024 LR rows of `match_trie` rerun through the
     plain path on the CPU must give byte-identical rows; a 20,000-read
     `extract_lr_bc` run (plus reads with N and one with > 4 ends, through
     MASK on the card) on the card and on the CPU must write identical TSVs,
     and so must its checkpointed runs (SCTAG_CHECKPOINT_BATCH=5000, five
     batches) on the card (K6 SLOTS and MASK launched) and on the CPU.
  6. the stage-2 paths, checkpoint/resume, the runner and the trace, each
     with its launch counts set to 0 just before it and read just after:
     - `extract_sr_bc` (host C++, no device work) on a 2,000,000-alignment
       BAM (tools/measure_reference.make_sr_bam): plain, checkpointed over
       >= 4 byte ranges (SCTAG_SR_BATCH_BYTES), and resumed after deleting
       one part: equal TSVs, only the deleted part written again;
     - `extract_sr_bc_from_lr` on 1,000,000 LR rows against a 3,000,000-row
       whitelist (make_alt_fixture): the host probe, the device probe on
       the card, the device probe on the first 50,000 rows under
       SCTAG_DEVICE=cpu against the card on the same rows, and a
       checkpointed run in 4 batches: equal TSVs; both probes' walls;
     - checkpointed `match_trie` on the flagship inputs of phase 4
       (SCTAG_CHECKPOINT_BATCH=262144: 4 batches): its TSV equals the
       un-checkpointed run's; after deleting one part, 3 batches skipped and
       1 computed, same bytes; K1/K2 launches and both walls;
     - the runner (`pipeline.runner.run_config`, --from-lr-only) on a
       5,000-read sample with a 1,000-barcode whitelist, on the card (K6
       SLOTS and K1/K2 launched) and under SCTAG_DEVICE=cpu: the three
       artifacts equal; a second call skips every rule;
     - SCTAG_PROFILE around a 1,024-row `match_trie` run: the trace names
       the match_full kernel (its CUDA kernel `match_sweep` and the
       `sctag_match_full` range).
  7. multi-host and the device grid:
     a. each stage at --n-hosts 2 as two processes on the card (one card
        takes both: NCCL cannot put two ranks on one GPU, so the transports
        are fs and gloo), on the inputs of phases 4 and 6 at full size: the
        flagship `match_trie`, `extract_lr_bc` on the phase-4 FASTQ,
        `extract_sr_bc` on the phase-6 BAM and `extract_sr_bc_from_lr`
        (device probe) on the phase-6 alt fixture, over fs; `extract_lr_bc`
        and the alt stage again over gloo (--coordinator). Each output
        equals the single-host output of phases 4 and 6; each wall and each
        host's K1/K6 launches are logged;
     b. the grid (parallel/mesh.py) on the card: `dryrun_multichip(2)` with
        SCTAG_VIRTUAL_DEVICES=2 (two slices on one card), and at
        torch.cuda.device_count() where that is > 1; the 16,384 x 50,000 K1
        chunk at data 2 and at model 2, and K6 SLOTS on 131,072 reads at
        data 2, each equal to its one-device launch (timed).

The kernels line holds, for every kernel, its time per call (``ms``,
between CUDA events) and two bounds: bound_ms, the larger of its bytes over
3.35 TB/s and its source ops over the measured ceiling, and issue_bound_ms,
the larger of its bytes and the instructions its function needs (per cell
the fewer of its source ops and its compiled loop's hot path) over the
issue rate at clocks.max.sm; a share (bound over time) above 105% in either
fails the run, as a wrong count. The line before the last is the
card's name and power limit; the last line is {"ok": true, "device":
{...}}. Exits nonzero, printing no result, without CUDA or outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_BARCODES = 25_000
HEAD_ROWS = 1024  # rows of the CPU plain-path check (plain Myers on the CPU is slow)
KERNEL_SRC = "sctagger_tpu_torch/csrc/match_full.cu"
ADAPTER_SRC = "sctagger_tpu_torch/csrc/adapter_scan.cu"
ADAPTER_REPLACES = (
    "sctagger_tpu/ops/adapter_pallas.py:255 (_adapter_scan_call; body "
    "_kernel :97)"
)
MICRO_SRC = "sctagger_tpu_torch/csrc/myers_micro.cu"
VARIANT_REPLACES = {
    "match_min": "sctagger_tpu/ops/match_pallas.py:452 (match_min_tpu; body "
                 "_match_min_kernel :137)",
    "match_best": "sctagger_tpu/ops/match_pallas.py:476 (match_best_tpu; body "
                  "_match_best_kernel :153)",
    "match_ties": "sctagger_tpu/ops/match_pallas.py:399 (match_ties_tpu; body "
                  "_match_ties_kernel :166)",
}
MICRO_REPLACES = "tools/roofline.py:114 (measure_vpu_bound.run_c; body _micro_kernel :55)"
ADAPTER = "CTACACGACGCTCTTCCGATCT"
LR_CHECK_READS = 20_000
LR_CKPT_BATCH = 5000
SR_ALNS = 2_000_000  # the repo's `sr` shape
ALT_ROWS, ALT_WHITELIST, ALT_HEAD = 1_000_000, 3_000_000, 50_000  # `alt_3m`
MATCH_CKPT_BATCH = 262_144
RUNNER_READS, RUNNER_WHITELIST = 5000, 1000
MASK_NSEGS = (1, 2, 4, 8, 16, 32)
SHARE_LIMIT = 1.05  # a share above this means a wrong count
REPLACES = (
    "sctagger_tpu/ops/match_pallas.py:207 (_match_full_kernel via "
    "match_full_tpu :357) + :260 (_match_full_dynls_kernel via "
    "match_full_dynls_tpu :316)"
)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def _env(**kv):
    """Set environment variables for the body, then restore them."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _need_launches(counts: dict, path: str) -> None:
    """Fail unless every kernel in ``counts`` launched in the run of ``path``."""
    idle = [k for k, n in counts.items() if n == 0]
    if idle:
        raise AssertionError(f"{path} launched no {', '.join(idle)}")


def _stats(path: pathlib.Path) -> dict:
    """The last SCTAG_STATS record in ``path``."""
    return json.loads(path.read_text().splitlines()[-1])


def _timed_once(fn):
    """(result, ms) of one call of ``fn`` between two CUDA events."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def _err(got, ref) -> int:
    """Largest absolute difference of two integer tensors (0 when equal)."""
    if got.shape != ref.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if got.dtype == ref.dtype and bool((got == ref).all()):
        return 0
    return int((got.long() - ref.long()).abs().max())


def _nbytes(*tensors) -> int:
    """Bytes of the given tensors: a launch's inputs read once and its
    output written once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _encode(segs, ls: int) -> np.ndarray:
    """(R, ls) uint8 codes of ACGT segments (A,C,G,T = 0..3, pad 4)."""
    table = np.zeros(256, np.uint8)
    table[np.frombuffer(b"CGT", np.uint8)] = (1, 2, 3)
    out = np.full((len(segs), ls), 4, np.uint8)
    for i, s in enumerate(segs):
        out[i, : len(s)] = table[np.frombuffer(s.encode(), np.uint8)]
    return out


def _rev_compl(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _case(rng, n_reads: int, n_bc: int, m: int, ls: int, ragged: bool):
    """Random reads with planted (mutated, possibly reverse-complement)
    barcodes; the whitelist holds one barcode ten times, so the reads planted
    with it overflow the 8 tie slots."""
    from sctagger_tpu_torch.models.matcher import MatchContext

    alpha = np.array(list("ACGT"))
    core = "".join(rng.choice(alpha, m))
    bcs = [core] * 10 + ["".join(rng.choice(alpha, m)) for _ in range(n_bc - 10)]
    segs = []
    for _ in range(n_reads):
        n = int(rng.integers(max(1, ls // 2), ls + 1)) if ragged else ls
        s = list(rng.choice(alpha, n))
        b = core if rng.random() < 0.1 else bcs[int(rng.integers(len(bcs)))]
        if rng.random() < 0.5:
            b = _rev_compl(b)
        b = list(b)
        for _ in range(int(rng.integers(0, 3))):
            b[int(rng.integers(m))] = str(rng.choice(alpha))
        p = int(rng.integers(0, max(1, n - m + 1)))
        s[p : p + m] = b[: max(0, min(m, n - p))]
        segs.append("".join(s[:n]))
    return MatchContext(bcs), segs


def check_kernels() -> dict:
    """Phase 3: kernel == plain version on the card. Returns the largest
    error and the timings of the flagship-shaped chunk."""
    import torch

    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.tools import cuda_ms, gpu_line

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    worst = 0
    cases = [(16, 24, False), (16, 40, True), (31, 48, True), (32, 40, False),
             (32, 64, True)]
    for m, ls, ragged in cases:
        ctx, segs = _case(rng, 3000, 300, m, ls, ragged)
        lens = np.array([len(s) for s in segs], np.int32)
        seg = torch.from_numpy(mc.prep_segs_T(_encode(segs, ls), ls)).to(dev)
        peq = torch.from_numpy(mc.prep_peq_cols(ctx.peq())).to(dev)
        ref = mc.match_full_ref(seg, peq, m)
        got = mc.match_full(seg, peq, m)
        ml = np.zeros(seg.shape[1], np.int32)
        ml[: lens.size] = lens
        ml = torch.from_numpy(ml.reshape(1, -1, mc.DEF_BR).max(axis=2)).to(dev)
        got_d = mc.match_full_dynls(seg, peq, ml, m)
        ref_d = mc.match_full_dynls_ref(seg, peq, ml, m)
        torch.cuda.synchronize()
        err = max(int((got - ref).abs().max()), int((got_d - ref_d).abs().max()))
        worst = max(worst, err)
        over = int((ref[1, : lens.size] > mc.TIES_K).sum())
        log(f"[kernel] m={m} ls={ls} ragged={ragged} reads={lens.size} "
            f"patterns={ctx.pat_codes.shape[0]} reads>8ties={over} "
            f"max_abs_err={err}")
        if err != 0 or not torch.equal(got_d, got) or over == 0:
            raise AssertionError(f"kernel disagrees with its plain version (m={m})")
    import bench

    from sctagger_tpu_torch.models.matcher import MatchContext

    segs, barcodes = bench.make_inputs(16_384, N_BARCODES, seed=0)
    ctx = MatchContext(barcodes)
    seg = torch.from_numpy(mc.prep_segs_T(_encode(segs, 24), 24)).to(dev)
    peq = torch.from_numpy(mc.prep_peq_cols(ctx.peq())).to(dev)
    ref = mc.match_full_ref(seg, peq, 16)
    got = mc.match_full(seg, peq, 16)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    worst = max(worst, err)
    log(f"[kernel] flagship chunk reads={seg.shape[1]} "
        f"patterns={ctx.pat_codes.shape[0]} ls=24 max_abs_err={err}")
    if err != 0:
        raise AssertionError("kernel disagrees with its plain version (flagship)")
    # K2 on the same chunk: every block's sweep bound is its 24 positions
    ml = torch.full((1, seg.shape[1] // mc.DEF_BR), 24, dtype=torch.int32, device=dev)
    if not torch.equal(mc.match_full_dynls(seg, peq, ml, 16), got):
        raise AssertionError("K2 (maxlens 24) differs from K1 on the flagship chunk")
    ms = cuda_ms(lambda: mc.match_full(seg, peq, 16), reps=10)
    dynls_ms = cuda_ms(lambda: mc.match_full_dynls(seg, peq, ml, 16), reps=10)
    plain_ms = cuda_ms(lambda: mc.match_full_ref(seg, peq, 16), reps=2)
    log(f"[kernel] flagship chunk: kernel {ms:.3f} ms (K2, maxlens 24: "
        f"{dynls_ms:.3f} ms), plain {plain_ms:.3f} ms ({gpu_line()})")
    return {"max_abs_err": worst, "ms": ms, "dynls_ms": dynls_ms, "plain_ms": plain_ms,
            "cells": seg.shape[1] * peq.shape[0] * 24,
            "bytes": _nbytes(seg, peq, got)}


def check_device_paths() -> int:
    """match_segments on the card == on the CPU: tie-overflow escalation
    (bl 16, through match_best / K5 on the card) and the multi-word path
    (bl 40, plain torch on both). Returns K5's launches in the bl 16 run."""
    from sctagger_tpu_torch.models.matcher import match_segments
    from sctagger_tpu_torch.ops import match_cuda as mc

    rng = np.random.default_rng(2)
    for m, ls in ((16, 24), (40, 48)):
        ctx, segs = _case(rng, 2000, 200, m, ls, ragged=True)
        res = {}
        for dev in ("cuda", "cpu"):
            mc.BEST_LAUNCHES = 0
            r = match_segments(segs, ctx.barcodes, 2, ctx=ctx, device=dev)
            res[dev] = (r.rids.tolist(), r.dists.tolist(), r.tie_counts.tolist(),
                        [r.ties_of(i).tolist() for i in range(r.rids.size)])
            if dev == "cuda" and m == 16:
                k5 = mc.BEST_LAUNCHES
        over = sum(c > 8 for c in res["cpu"][2])
        log(f"[paths] bl={m}: {len(res['cpu'][0])} matched, {over} with > 8 "
            f"ties; card == cpu: {res['cuda'] == res['cpu']}"
            + (f"; match_best (K5) launches in the escalation: {k5}" if m == 16 else ""))
        if res["cuda"] != res["cpu"] or over == 0:
            raise AssertionError(f"match_segments differs on the card (bl={m})")
    if k5 == 0:
        raise AssertionError("the > 8-ties escalation launched no match_best (K5)")
    return k5


def check_match_variants() -> dict:
    """Phase 3c: K4, K5 and K3 == their plain versions on the card (exact),
    then the timed flagship-shaped chunk. Returns per kernel the largest
    error and the chunk's kernel and plain times."""
    import torch

    import bench
    from sctagger_tpu_torch.models.matcher import MatchContext
    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.tools import cuda_ms, gpu_line

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    worst = dict.fromkeys(VARIANT_REPLACES, 0)
    split_seen = set()
    # (m, ls, ragged, reads, barcodes): 600 patterns split into 3 merged
    # launches (200 reads: the fewest); 100 barcodes fit one Peq tile, no split
    cases = [(16, 24, False, 3000, 300), (16, 40, True, 3000, 300),
             (31, 48, True, 3000, 300), (32, 40, False, 3000, 300),
             (32, 64, True, 3000, 300), (16, 24, False, 200, 300),
             (16, 24, True, 3000, 100)]
    for m, ls, ragged, n_reads, n_bc in cases:
        ctx, segs = _case(rng, n_reads, n_bc, m, ls, ragged)
        seg = torch.from_numpy(mc.prep_segs_T(_encode(segs, ls), ls)).to(dev)
        peq = torch.from_numpy(mc.prep_peq_cols(ctx.peq())).to(dev)
        full = mc.match_full_ref(seg, peq, m)
        n_split = mc.split_of(dev, seg.shape[1], peq.shape[0])[1]
        split_seen.add(n_split > 1)
        at_min = full[0].contiguous()
        at_m = torch.full_like(at_min, m)
        pairs = {
            "match_min": (mc.match_min(seg, peq, m), mc.match_min_ref(seg, peq, m)),
            "match_best": (mc.match_best(seg, peq, m), mc.match_best_ref(seg, peq, m)),
            "match_ties": (mc.match_ties(seg, peq, at_min, m),
                           mc.match_ties_ref(seg, peq, at_min, m)),
            "match_ties@m": (mc.match_ties(seg, peq, at_m, m),
                             mc.match_ties_ref(seg, peq, at_m, m)),
        }
        torch.cuda.synchronize()
        errs = {k: _err(*v) for k, v in pairs.items()}
        # K4 is K1's row 0; K3 at K1's minima is K1's rows 1..
        agree = (torch.equal(pairs["match_min"][0], full[:1])
                 and torch.equal(pairs["match_ties"][0], full[1:]))
        for k, e in errs.items():
            worst[k.split("@")[0]] = max(worst[k.split("@")[0]], e)
        hits_m = int((pairs["match_ties@m"][1][0] > 0).sum())
        log(f"[variants] m={m} ls={ls} ragged={ragged} reads={n_reads} "
            f"patterns={ctx.pat_codes.shape[0]} splits={n_split} "
            f"reads>8ties={int((full[1, :n_reads] > mc.TIES_K).sum())} "
            f"reads with hits at m={hits_m} max_abs_err={errs} "
            f"== match_full rows: {agree}")
        if any(errs.values()) or not agree:
            raise AssertionError(f"K3/K4/K5 disagree with their plain versions (m={m})")
    if split_seen != {True, False}:
        raise AssertionError(f"split and unsplit launches not both run: {split_seen}")

    segs, barcodes = bench.make_inputs(16_384, N_BARCODES, seed=0)
    ctx = MatchContext(barcodes)
    seg = torch.from_numpy(mc.prep_segs_T(_encode(segs, 24), 24)).to(dev)
    peq = torch.from_numpy(mc.prep_peq_cols(ctx.peq())).to(dev)
    target = mc.match_full(seg, peq, 16)[0].contiguous()
    runs = {
        "match_min": (lambda: mc.match_min(seg, peq, 16),
                      lambda: mc.match_min_ref(seg, peq, 16)),
        "match_best": (lambda: mc.match_best(seg, peq, 16),
                       lambda: mc.match_best_ref(seg, peq, 16)),
        "match_ties": (lambda: mc.match_ties(seg, peq, target, 16),
                       lambda: mc.match_ties_ref(seg, peq, target, 16)),
    }
    out = {}
    for name, (kern, plain) in runs.items():
        ref, plain_ms = _timed_once(plain)
        err = _err(kern(), ref)
        del ref
        worst[name] = max(worst[name], err)
        ms = cuda_ms(kern, reps=10)
        log(f"[variants] {name} flagship chunk reads={seg.shape[1]} "
            f"patterns={ctx.pat_codes.shape[0]} ls=24: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, max_abs_err={err} ({gpu_line()})")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version (flagship)")
        out[name] = {"max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
                     "cells": seg.shape[1] * peq.shape[0] * 24,
                     "bytes": _nbytes(seg, peq, kern())}
    return out


def check_micro() -> dict:
    """Phase 3d: K7 == micro_ref on the card at every chain count, on a
    bp 8 x br 128 block (16 iterations, grid 2) and at tools.roofline's
    ceiling shape (bp max(8, 256 // chains) x 1,024, MICRO_ITERS iterations,
    grid MICRO_GRID), where the plain version is timed once per chain count
    (tools.roofline times the kernel there)."""
    from sctagger_tpu_torch.ops import micro_cuda as mic
    from sctagger_tpu_torch.tools import gpu_line, roofline

    worst = 0
    plain = {}
    for chains in mic.CHAINS:
        for bp, br, iters, grid in ((8, 128, 16, 2),
                                    (max(8, roofline.MICRO_BP // chains), roofline.MICRO_BR,
                                     roofline.MICRO_ITERS, roofline.MICRO_GRID)):
            x = mic.micro_input(bp, br).to("cuda")
            ref, plain_ms = _timed_once(lambda: mic.micro_ref(x, iters, chains))
            err = _err(mic.micro(x, iters, chains, grid=grid), ref)
            worst = max(worst, err)
            log(f"[k7] chains={chains} bp={bp} br={br} iters={iters} grid={grid} "
                f"max_abs_err={err}; plain {plain_ms:.3f} ms ({gpu_line()})")
            if err:
                raise AssertionError(f"K7 disagrees with micro_ref (chains={chains})")
        plain[chains] = plain_ms
    return {"max_abs_err": worst, "plain_ms": plain}


def _write_inputs(tmp: pathlib.Path, segs, barcodes):
    sr = tmp / "sr.tsv"
    sr.write_text("".join(f"{b}\t1\n" for b in barcodes))
    lr = tmp / "lr.tsv"
    with open(lr, "w") as f:
        f.writelines(f"r{i}\t0\t4\t{s}\n" for i, s in enumerate(segs))
    return sr, lr


def main_path(n_segments: int, tmp: pathlib.Path) -> dict:
    """Phases 4a and 5a: match_trie."""
    import torch

    import bench
    from sctagger_tpu_torch import cli
    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.stages import match_trie
    from sctagger_tpu_torch.tools import gpu_line

    t0 = time.perf_counter()
    segs, barcodes = bench.make_inputs(n_segments, N_BARCODES, seed=0)
    sr, lr = _write_inputs(tmp, segs, barcodes)
    log(f"[main] inputs: {n_segments} segments x {N_BARCODES} barcodes "
        f"({time.perf_counter() - t0:.1f}s to generate)")
    out = tmp / "out.tsv"
    stats_path = tmp / "stats.jsonl"
    os.environ["SCTAG_STATS"] = str(stats_path)
    argv = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2",
            "-o", str(out)]
    mc.LAUNCHES = mc.BEST_LAUNCHES = 0
    ac.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k5 = mc.LAUNCHES, mc.BEST_LAUNCHES
    st = _stats(stats_path)
    c = st["counters"]
    log(f"[main] match_trie wall {wall:.3f}s = {n_segments / wall:.1f} "
        f"segments/s ({gpu_line()}); stage timers {st['timers_s']}")
    log(f"[main] prefilter-resolved {int(c['prefilter_resolved'])}, "
        f"kernel reads {int(c['device_reads'])} in "
        f"{int(c['device_chunks'])} chunks, kernel launches {launches}, "
        f"matched {int(c['matched'])}, > 8-ties reads escalated "
        f"{int(c['escalated_reads'])} with {k5} match_best (K5) launches")
    if launches == 0:
        raise AssertionError("the main path launched no kernel")
    if bool(c["escalated_reads"]) != bool(k5):
        raise AssertionError("the escalated reads and K5's launches disagree")

    # phase 5: the first rows through the plain path on the CPU
    head = tmp / "lr_head.tsv"
    with open(lr) as src, open(head, "w") as dst:
        for _ in range(HEAD_ROWS):
            dst.write(src.readline())
    cpu_out = tmp / "out_cpu.tsv"
    t0 = time.perf_counter()
    match_trie.run(
        cli.parse_args(["match_trie", "-lr", str(head), "-sr", str(sr),
                    "-mr", "2", "-o", str(cpu_out)]),
        device="cpu",
    )
    want = cpu_out.read_text().splitlines()
    got = [ln for ln in out.read_text().splitlines()
           if int(ln.split("\t", 1)[0][1:]) < HEAD_ROWS]
    log(f"[check] first {HEAD_ROWS} LR rows on the CPU plain path: "
        f"{len(want)} matched rows ({time.perf_counter() - t0:.1f}s); card "
        f"rows equal: {got == want}")
    if got != want or not want:
        raise AssertionError("card output differs from the CPU plain path")
    return {"launches": launches, "k5_launches": k5, "wall_s": wall, "lr": lr,
            "sr": sr, "out": out, "head": head}


def _dna(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes().decode()


def _mutate(rng, s: str, k: int) -> str:
    b = list(s)
    for _ in range(k):
        at = int(rng.integers(len(b)))
        op = int(rng.integers(3))
        if op == 0:
            b[at] = "ACGT"[int(rng.integers(4))]
        elif op == 1 and len(b) > 1:
            del b[at]
        else:
            b.insert(at, "ACGT"[int(rng.integers(4))])
    return "".join(b)


def _adapter_reads(rng, adapter: str, n: int, lo: int, hi: int) -> list[str]:
    """Reads of lo..hi bp; most carry a mutated adapter on either strand."""
    out = []
    for _ in range(n):
        t = _dna(rng, int(rng.integers(lo, hi + 1)))
        r = rng.random()
        a = adapter if r < 0.4 else _rev_compl(adapter) if r < 0.8 else ""
        a = _mutate(rng, a, int(rng.integers(0, 4))) if a else a
        if a and len(t) >= len(a):
            p = int(rng.integers(0, len(t) - len(a) + 1))
            t = t[:p] + a + t[p + len(a):]
        out.append(t)
    return out


def _k6_rows(reads, adapter: str):
    """One kernel chunk of ``reads`` on the card: (text, lens, peq, m)."""
    import torch

    from sctagger_tpu_torch.core.packing import encode_str
    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.ops.myers import build_peq_multi

    lens = np.array([len(r) for r in reads])
    text, ln, junk = ac.pack_chunk(reads, np.arange(len(reads)), int(lens.max()))
    assert not junk.any()
    peq = ac.prep_peq(build_peq_multi(np.stack(
        [encode_str(adapter), encode_str(_rev_compl(adapter))])))
    dev = torch.device("cuda")
    return (torch.from_numpy(text).to(dev), torch.from_numpy(ln).to(dev), peq,
            len(adapter))


def _k6_compare(name: str, args, m: int, adapter_len: int, reads=None) -> int:
    """SLOTS == adapter_scan_ref on one chunk at the default segment count
    and at 1 and 32 segments per read. Returns the largest error."""
    import torch

    from sctagger_tpu_torch.ops import adapter_cuda as ac

    ref = ac.adapter_scan_ref(*args)
    runs = {"default": ac.adapter_scan(*args)}
    for nseg in (1, 32):
        runs[f"nseg={nseg}"] = ac.adapter_scan(*args, nseg=nseg)
    torch.cuda.synchronize()
    errs = {k: _err(v, ref) for k, v in runs.items()}
    over = int(((ref[1] > ac.SLOTS_K) | (ref[7] > ac.SLOTS_K)).sum())
    empty_ok = True
    if reads is not None:
        empty = [i for i, r in enumerate(reads) if not r]
        empty_ok = all(int(ref[0, i]) == adapter_len == int(ref[6, i]) for i in empty)
    nseg = ac.nseg_for(*args[0].shape)
    log(f"[k6] {name}: reads={args[0].shape[0]} default nseg={nseg} "
        f"reads>4ends={over} max_abs_err={errs}")
    if any(errs.values()) or not empty_ok:
        raise AssertionError(f"K6 SLOTS disagrees with adapter_scan_ref ({name})")
    if "> 4 ends" in name and over == 0:
        raise AssertionError(f"no read with > 4 ends in case {name}")
    return max(errs.values())


def check_adapter_kernel() -> dict:
    """Phase 3b: K6's SLOTS entry == adapter_scan_ref on the card (full rows,
    exact) on every case, at several segment counts; then the realistic
    chunks of 16,384 reads (the one tools.roofline reads K6 on) and of
    131,072 reads (the main path's largest), timed, and one of 300 reads."""
    import torch

    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.tools import cuda_ms, gpu_line, roofline

    rng = np.random.default_rng(3)
    adapters = {22: ADAPTER, 31: ADAPTER + "AGTCAGGTA", 32: ADAPTER + "AGTCAGGTAC"}
    worst = 0
    cases = []
    for m, a in adapters.items():
        cases.append((f"m={m} uniform 400 bp", a, _adapter_reads(rng, a, 3000, 400, 400)))
        reads = _adapter_reads(rng, a, 3000, 0, 600)
        reads += ["", "", a[: m // 2], _dna(rng, m - 1), "CC" + (a + "TTT") * 6]
        cases.append((f"m={m} ragged 0-600 bp, empty, < m, > 4 ends", a, reads))
    long_reads = _adapter_reads(rng, ADAPTER, 3, 70_000, 72_000)
    long_reads += _adapter_reads(rng, ADAPTER, 61, 0, 3000) + ["CC" + (ADAPTER + "T") * 9]
    cases.append(("m=22 three reads >= 70,000 bp + short", ADAPTER, long_reads))
    for name, a, reads in cases:
        worst = max(worst, _k6_compare(name, _k6_rows(reads, a), len(a), len(a), reads))

    dev = torch.device("cuda")
    out = {}
    for n in (300, 16_384, 131_072):
        args = roofline.adapter_chunk(dev, n=n)
        worst = max(worst, _k6_compare(f"chunk of {n:,} reads", args, args[3], args[3]))
        if n == 300:
            continue
        ms = cuda_ms(lambda: ac.adapter_scan(*args), reps=20)
        plain_ms = cuda_ms(lambda: ac.adapter_scan_ref(*args), reps=1)
        log(f"[k6] chunk of {n:,} reads x 1,000-3,000 bp ({args[0].shape[1]} "
            f"bytes/row, nseg {ac.nseg_for(*args[0].shape)}): kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms ({gpu_line()})")
        out[n] = {"ms": ms, "plain_ms": plain_ms, "chars": int(args[1].sum()),
                  "bytes": _nbytes(args[0], args[1]) + ac.N_OUT * n * 4}
        del args
    return {"max_abs_err": worst, **out[16_384], "main_chunk": out[131_072]}


def check_adapter_mask() -> dict:
    """Phase 3b': K6's MASK entry == adapter_mask_ref (the JAX mask path's
    hw_block + a bit pack) on the card, exact d and mask bits, at m 22/31/32
    with junk, > 4 and > 64 ends, empty and < m reads and three reads of
    >= 70,000 bp, at the default segment count and at every forced one;
    then timed by tools.roofline.measure_mask on 102 and 4,096 junk reads
    of 1,000-3,000 bp and on one empty read (the launch floor)."""
    import torch

    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.tools import gpu_line, roofline

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    adapters = {22: ADAPTER, 31: ADAPTER + "AGTCAGGTA", 32: ADAPTER + "AGTCAGGTAC"}
    worst = 0
    for m, a in adapters.items():
        reads = roofline.add_junk(rng, _adapter_reads(rng, a, 200, 0, 900))
        reads += ["", "", "N" * 40, a[: m // 2], _dna(rng, m - 1),
                  "CC" + (a + "TTT") * 6, "G" + (a + "A") * 70 + "N" + a,
                  "A" * 500, a[:5] + "N" + a[6:]]
        if m == 22:
            reads += roofline.add_junk(rng, _adapter_reads(rng, a, 3, 70_000, 72_000), 0.001)
        args = roofline.mask_rows(reads, dev, a)
        ref = ac.adapter_mask_ref(*args)
        runs = {"default": ac.adapter_mask(*args),
                **{f"nseg={n}": ac.adapter_mask(*args, nseg=n) for n in MASK_NSEGS}}
        torch.cuda.synchronize()
        errs = {k: max(_err(g, r) for g, r in zip(v, ref)) for k, v in runs.items()}
        worst = max(worst, *errs.values())
        ends = np.array([ac.mask_ends(w).size for w in ref[1][:, 0].cpu().numpy()])
        log(f"[mask] m={m}: reads={len(reads)} with junk={sum('N' in r for r in reads)} "
            f"reads>4 fwd ends={int((ends > 4).sum())} >64={int((ends > 64).sum())} "
            f"longest={max(map(len, reads))} default nseg="
            f"{ac.mask_nseg_for(*args[0].shape)} max_abs_err={errs}")
        if any(errs.values()) or not (ends > 64).any():
            raise AssertionError(f"K6 MASK disagrees with adapter_mask_ref (m={m})")
    timed = roofline.measure_mask(dev, sweep=True)
    for tag, t in timed.items():
        by_nseg = {n: round(ms, 5) for n, ms in t.get("device_ms_by_nseg", {}).items()}
        log(f"[mask] {tag}: {t['reads']} reads, {t['chars']} chars (nseg {t['nseg']}): "
            f"kernel {t['ms']:.4f} ms a call, {t['device_ms']:.4f} ms on the card with "
            f"the launches queued, plain {t['plain_ms']:.3f} ms, max_abs_err="
            f"{t['max_abs_err']}; device ms by forced nseg {by_nseg} ({gpu_line()})")
    return {"max_abs_err": worst, **timed["main"], "full": timed["full"],
            "floor": timed["floor"]}


def stage1_main_path(n_reads: int, tmp: pathlib.Path) -> dict:
    """Phase 4b: extract_lr_bc through the CLI on the card."""
    import torch

    import measure_reference
    from sctagger_tpu_torch import cli
    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.tools import gpu_line

    fq = tmp / "lr.fastq"
    t0 = time.perf_counter()
    bp = measure_reference.make_lr_fastq(fq, n_reads, 2000, seed=42, err_rate=0.05)
    log(f"[lr] input: {n_reads} reads, {bp} bp, adapter at 0-19 with 5% "
        f"substitutions ({time.perf_counter() - t0:.1f}s to generate)")
    out = tmp / "lr_out.tsv.gz"
    stats_path = tmp / "stats_lr.jsonl"
    os.environ["SCTAG_STATS"] = str(stats_path)
    mc.LAUNCHES = 0
    ac.LAUNCHES = ac.MASK_LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["extract_lr_bc", "-r", str(fq), "-o", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, mask_launches = ac.LAUNCHES, ac.MASK_LAUNCHES
    st = _stats(stats_path)
    t, c = st["timers_s"], st["counters"]
    resolved = sum(c.get(f"scan.d{d}_resolved_reads", 0) for d in range(3))
    plain = int(c.get("scan.mask_reads", 0))
    log(f"[lr] extract_lr_bc wall {wall:.3f}s = {n_reads / wall:.1f} reads/s "
        f"({gpu_line()}); stage timers {t}")
    log(f"[lr] prefilter-resolved {int(resolved)}, prefilter-deferred "
        f"{int(c.get('scan.prefilter_deferred_reads', 0))}, kernel reads "
        f"{int(c.get('scan.kernel_reads', 0))} in "
        f"{int(c.get('scan.kernel_chunks', 0))} chunks, K6 SLOTS launches "
        f"{launches}; mask fallback {t.get('scan.mask_fallback', 0.0)}s: MASK reads "
        f"{int(c.get('scan.mask_kernel_reads', 0))} in {mask_launches} launches, "
        f"plain-torch mask reads {plain}")
    if launches == 0 or mask_launches == 0:
        raise AssertionError("the extract_lr_bc main path launched no K6 SLOTS or MASK")
    if plain:
        raise AssertionError(f"{plain} reads took the plain-torch mask path on the card")
    with gzip.open(out, "rt") as f:
        rows = [ln.split("\t") for ln in f]
    valid = sum(r[1] != "-1" for r in rows)
    log(f"[lr] {len(rows)} rows, {valid} with an adapter in range")
    if len(rows) != n_reads or any(len(r) != 4 for r in rows) or valid < n_reads // 2:
        raise AssertionError("extract_lr_bc output has the wrong shape")
    return {"launches": launches, "mask_launches": mask_launches, "wall_s": wall,
            "fq": fq, "out": out}


def check_stage1_output(tmp: pathlib.Path) -> None:
    """Phase 5b: the whole stage on the card and on the CPU, same TSV, and
    its checkpointed runs too."""
    import measure_reference
    from sctagger_tpu_torch import cli
    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.stages import extract_lr_bc

    fq = tmp / "lr_check.fastq"
    measure_reference.make_lr_fastq(fq, LR_CHECK_READS, 2000, seed=7, err_rate=0.05)
    rng = np.random.default_rng(11)
    extra = _adapter_reads(rng, ADAPTER, 6, 500, 2500)
    extra = [r[:100] + "N" + r[101:300] + "NN" + r[302:] for r in extra]
    extra.append("CC" + (ADAPTER + "TTT") * 6 + _dna(rng, 500))  # > 4 ends
    with open(fq, "a") as f:
        f.writelines(f"@x{i} y\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(extra))
    tsv = {}
    for dev in ("cuda", "cpu"):
        out = tmp / f"lr_check_{dev}.tsv.gz"
        t0 = time.perf_counter()
        ac.MASK_LAUNCHES = 0
        extract_lr_bc.run(
            cli.parse_args(["extract_lr_bc", "-r", str(fq), "-o", str(out)]),
            device=dev,
        )
        tsv[dev] = gzip.decompress(out.read_bytes())
        log(f"[check] extract_lr_bc {LR_CHECK_READS + len(extra)} reads on "
            f"{dev}: {time.perf_counter() - t0:.1f}s, MASK launches {ac.MASK_LAUNCHES}")
        if dev == "cuda" and ac.MASK_LAUNCHES == 0:
            raise AssertionError("the junk and > 4-end reads launched no MASK")
    n = tsv["cpu"].count(b"\n")
    log(f"[check] card TSV == CPU TSV: {tsv['cuda'] == tsv['cpu']} ({n} rows)")
    if tsv["cuda"] != tsv["cpu"] or n != LR_CHECK_READS + len(extra):
        raise AssertionError("extract_lr_bc on the card differs from the CPU")
    for dev in ("cuda", "cpu"):  # checkpointed: the scan per 5,000-read batch
        ckpt = tmp / f"ckpt_lr_{dev}"
        out = tmp / f"lr_check_ckpt_{dev}.tsv.gz"
        with _env(SCTAG_CHECKPOINT_DIR=str(ckpt),
                  SCTAG_CHECKPOINT_BATCH=str(LR_CKPT_BATCH)):
            ac.LAUNCHES = ac.MASK_LAUNCHES = 0
            t0 = time.perf_counter()
            extract_lr_bc.run(
                cli.parse_args(["extract_lr_bc", "-r", str(fq), "-o", str(out)]),
                device=dev,
            )
            wall = time.perf_counter() - t0
            slots, mask = ac.LAUNCHES, ac.MASK_LAUNCHES
        parts = len(list(ckpt.glob("extract_lr_bc_scan-*/part*.npz")))
        same = gzip.decompress(out.read_bytes()) == tsv["cuda"]
        log(f"[ckpt] extract_lr_bc on {dev}, {parts} batches of {LR_CKPT_BATCH}: "
            f"{wall:.1f}s, K6 SLOTS launches {slots}, MASK launches {mask}; TSV == "
            f"the streamed run's: {same}")
        if not same or parts != -(-n // LR_CKPT_BATCH):
            raise AssertionError(f"checkpointed extract_lr_bc on {dev} differs")
        if dev == "cuda":
            _need_launches({"adapter_scan": slots, "adapter_mask": mask},
                           "checkpointed extract_lr_bc")


def entry_path() -> int:
    """Phase 4c: the port's entry() on the card (K4), output == the CPU
    plain version's. Returns K4's launches."""
    import torch

    from sctagger_tpu_torch import entry
    from sctagger_tpu_torch.ops import match_cuda as mc

    mc.MIN_LAUNCHES = 0
    fn, args = entry.entry()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = mc.MIN_LAUNCHES
    want = fn(*(a.cpu() for a in args))
    ok = (got.device.type == "cuda" and tuple(got.shape) == (1, 128)
          and torch.equal(got.cpu(), want))
    log(f"[entry] fn(*example_args) on {got.device}: shape {tuple(got.shape)}, "
        f"first 8 {got[0, :8].tolist()}, K4 launches {launches}; == CPU: {ok}")
    if not ok or launches == 0:
        raise AssertionError("entry() on the card differs from the CPU or ran no K4")
    return launches


def profile_path() -> dict:
    """Phase 4d: tools.profile_match on the card (K4, K5, K3). Returns each
    kernel's launches."""
    import torch

    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.tools import gpu_line, profile_match

    mc.MIN_LAUNCHES = mc.BEST_LAUNCHES = mc.TIES_LAUNCHES = 0
    res = profile_match.run(torch.device("cuda"), reps=2)
    torch.cuda.synchronize()
    launches = {"match_min": mc.MIN_LAUNCHES, "match_best": mc.BEST_LAUNCHES,
                "match_ties": mc.TIES_LAUNCHES}
    log(f"[profile] {json.dumps(res)}; launches {launches} ({gpu_line()})")
    if not all(launches.values()):
        raise AssertionError(f"profile_match launched no kernel of {launches}")
    return launches


def roofline_path() -> dict:
    """Phase 4e: tools.roofline on the card (K7, K1, K6). Returns its JSON
    object and K7's launches."""
    import math

    import torch

    from sctagger_tpu_torch.ops import micro_cuda as mic
    from sctagger_tpu_torch.tools import roofline

    mic.LAUNCHES = 0
    res = roofline.run(torch.device("cuda"))
    torch.cuda.synchronize()
    launches = mic.LAUNCHES
    log(f"[roofline] {json.dumps(res)}")
    ceil = res["ceiling"]["ops_per_s"]
    shares = {k: v["share_of_ceiling"] for k, v in res["kernels"].items()}
    issue = res["issue"]
    k7 = {c: v.get("issue_share") for c, v in res["ceiling"]["by_chains"].items()}
    log(f"[roofline] int32 ceiling {ceil / 1e12:.3f} T source ops/s (best of "
        f"chains 1/2/4/8); shares of it: {shares}; K7 launches {launches}")
    log(f"[roofline] issue rate {issue['lanes_per_s'] / 1e12:.3f} T lane-instructions/s "
        f"({issue['sms']} SMs x 4 x 32 x {issue['max_sm_mhz']} MHz clocks.max.sm; "
        f"clocks.sm under K7 {issue['sm_mhz_under_k7']} MHz); K7's SASS rate as a share "
        f"of it by chains {k7}; K1/K6 issue shares "
        f"{ {k: v.get('issue_share') for k, v in res['kernels'].items()} }")
    if launches == 0 or not math.isfinite(ceil) or ceil <= 0 or not all(
            math.isfinite(s) and s > 0 for s in shares.values()):
        raise AssertionError("roofline gave no ceiling or no shares")
    return {"launches": launches, "roofline": res}


def check_sr_stage(tmp: pathlib.Path, n_alns: int = SR_ALNS) -> dict:
    """Phase 6a: extract_sr_bc (host C++) through the CLI: plain, then
    checkpointed over >= 4 compressed byte ranges, then resumed after
    deleting one part. All TSVs equal; the resume writes only that part."""
    import measure_reference
    from sctagger_tpu_torch import cli
    from sctagger_tpu_torch.tools import gpu_line

    t0 = time.perf_counter()
    bam = measure_reference.make_sr_bam(tmp, n_alns)
    size = os.path.getsize(bam)
    log(f"[sr] input: {n_alns:,} alignments, {size:,} bytes of BAM "
        f"({time.perf_counter() - t0:.1f}s to generate)")
    stats_path = tmp / "stats_sr.jsonl"
    walls = {}

    def _run(tag: str) -> bytes:
        out = tmp / f"sr_{tag}.tsv.gz"
        t0 = time.perf_counter()
        cli.main(["extract_sr_bc", "-i", bam, "-o", str(out)])
        walls[tag] = time.perf_counter() - t0
        st = _stats(stats_path)
        log(f"[sr] extract_sr_bc {tag}: wall {walls[tag]:.3f}s = "
            f"{n_alns / walls[tag]:,.0f} alignments/s ({gpu_line()}); stage "
            f"timers {st['timers_s']}; counters {st['counters']}")
        return gzip.decompress(out.read_bytes())

    ckpt = tmp / "ckpt_sr"
    with _env(SCTAG_STATS=str(stats_path)):
        want = _run("plain")
        with _env(SCTAG_CHECKPOINT_DIR=str(ckpt), SCTAG_SR_BATCH_BYTES=str(size // 4)):
            got = _run("checkpointed")
            parts = sorted(ckpt.glob("extract_sr_bc-*/part*.npz"))
            gone = parts[1]
            gone.unlink()
            kept = {q: q.stat().st_mtime_ns for q in parts if q != gone}
            resumed = _run("resumed")
    untouched = all(q.stat().st_mtime_ns == t for q, t in kept.items())
    log(f"[sr] {len(parts)} byte ranges; resume rewrote {gone.name}: "
        f"{gone.exists()}, other parts untouched: {untouched}; TSVs equal: "
        f"{want == got == resumed} ({len(want.splitlines())} barcodes)")
    if len(parts) < 4 or not (want == got == resumed) or not want:
        raise AssertionError("checkpointed extract_sr_bc differs from the plain run")
    if not gone.exists() or not untouched:
        raise AssertionError("the extract_sr_bc resume did not rewrite exactly one part")
    return {"walls": walls, "bam": bam, "want": want}


def check_alt_stage(tmp: pathlib.Path, n_rows: int = ALT_ROWS,
                    n_wl: int = ALT_WHITELIST, n_head: int = ALT_HEAD) -> dict:
    """Phase 6b: extract_sr_bc_from_lr on the CPU (the host probe) and on
    the card (the device probe); the two probe functions called on the
    first ``n_head`` rows: the device probe on the CPU and on the card
    against the host probe; a checkpointed run on the card in 4 batches.
    All TSVs equal, all probe arrays equal. Returns the walls and probe
    times."""
    import numpy as np
    import torch

    import measure_reference
    from sctagger_tpu_torch import cli
    from sctagger_tpu_torch.io.tsv import read_lr_segments_tsv
    from sctagger_tpu_torch.io.whitelist import read_whitelist
    from sctagger_tpu_torch.ops import exact_lookup as xl
    from sctagger_tpu_torch.stages import extract_sr_bc_from_lr
    from sctagger_tpu_torch.tools import gpu_line

    sub = tmp / "alt"
    sub.mkdir()
    t0 = time.perf_counter()
    wl_n = measure_reference.make_alt_fixture(sub, n_rows, n_wl)
    wl, lr = sub / "wl.txt.gz", sub / "lr.tsv"
    head = sub / "lr_head.tsv"
    with open(lr) as src, open(head, "w") as dst:
        for _ in range(n_head):
            dst.write(src.readline())
    log(f"[alt] input: {n_rows:,} LR rows against {wl_n:,} whitelist barcodes "
        f"({time.perf_counter() - t0:.1f}s to generate)")
    stats_path = sub / "stats.jsonl"
    res = {}

    def _run(tag: str, rows: pathlib.Path, device: str) -> bytes:
        probe = "host" if device == "cpu" else "device"
        out = sub / f"{tag}.tsv.gz"
        with _env(SCTAG_STATS=str(stats_path)):
            t0 = time.perf_counter()
            extract_sr_bc_from_lr.run(cli.parse_args(
                ["extract_sr_bc_from_lr", "-i", str(rows), "-wl", str(wl),
                 "-o", str(out)]), device=device)
            wall = time.perf_counter() - t0
        st = _stats(stats_path)
        res[tag] = {"wall_s": wall, "probe_s": st["timers_s"]["probe"]}
        log(f"[alt] {tag} ({probe} probe): wall {wall:.3f}s, probe "
            f"{st['timers_s']['probe']:.3f}s ({gpu_line()}); stage timers "
            f"{st['timers_s']}; counters {st['counters']}")
        return gzip.decompress(out.read_bytes())

    host = _run("host", lr, "cpu")
    card = _run("device", lr, "cuda")
    # the two probe functions on the first rows' segments (the stage's own
    # parse): the device probe on the CPU and on the card, the host probe
    _, _, locs, segs = read_lr_segments_tsv(str(head))
    segs = segs.take([i for i, p in enumerate(locs) if p != "NA"])
    words = read_whitelist(str(wl))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    k = words.k
    head_host = xl._probe_rows_host(segs, *xl.build_key_table(words), k)
    head_cpu = xl._probe_segments_device(segs, *xl.build_key_table(words), k,
                                         xl.PROBE_CHUNK, cpu)
    head_card = xl._probe_segments_device(segs, *xl.build_key_table(words, device=cuda),
                                          k, xl.PROBE_CHUNK, cuda)
    head_same = all(np.array_equal(a, b) and np.array_equal(a, c)
                    for a, b, c in zip(head_host, head_cpu, head_card))
    ckpt = sub / "ckpt"
    with _env(SCTAG_CHECKPOINT_DIR=str(ckpt),
              SCTAG_CHECKPOINT_BATCH=str(-(-n_rows // 4))):
        checkpointed = _run("checkpointed", lr, "cuda")
    parts = len(list(ckpt.glob("extract_sr_bc_from_lr_scan-*/part*.npz")))
    log(f"[alt] host == device: {host == card}; checkpointed ({parts} batches) "
        f"== host: {checkpointed == host}; first {n_head:,} rows, device probe on the "
        f"CPU == on the card == host probe: {head_same} ({len(segs):,} segments, "
        f"{int((head_host[0] == 1).sum()):,} single hits); {len(host.splitlines())} "
        f"barcodes written; walls "
        f"host {res['host']['wall_s']:.3f}s vs device {res['device']['wall_s']:.3f}s "
        f"({gpu_line()})")
    if not host or host != card or host != checkpointed or parts != 4:
        raise AssertionError("extract_sr_bc_from_lr differs between probes or batches")
    if not head_same or not (head_host[0] == 1).any():
        raise AssertionError("the device probe on the CPU, on the card and the host "
                             "probe differ")
    return {**res, "lr": lr, "wl": wl, "want": host}


def check_match_checkpoint(main: dict, tmp: pathlib.Path) -> dict:
    """Phase 6c: the un-checkpointed flagship match_trie again (warm, as the
    checkpointed runs are), then checkpointed in 4 batches, then a resume
    after deleting one part: same bytes as phase 4's run, 1 batch computed
    and 3 skipped on the resume."""
    import torch

    from sctagger_tpu_torch import cli
    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.tools import gpu_line

    want = main["out"].read_bytes()
    ckpt = tmp / "ckpt_mt"
    stats_path = tmp / "stats_ckpt.jsonl"
    runs = {}

    def _run(tag: str):
        out = tmp / f"out_{tag}.tsv"
        mc.LAUNCHES = 0
        t0 = time.perf_counter()
        cli.main(["match_trie", "-lr", str(main["lr"]), "-sr", str(main["sr"]),
                  "-mr", "2", "-o", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = _stats(stats_path)["counters"]
        got = out.read_bytes()
        runs[tag] = {"wall_s": wall, "launches": mc.LAUNCHES,
                     "computed": int(c.get("batches_computed", 0)),
                     "skipped": int(c.get("batches_skipped", 0))}
        log(f"[ckpt] match_trie {tag}: wall {wall:.3f}s (phase 4, cold: "
            f"{main['wall_s']:.3f}s) ({gpu_line()}); K1/K2 launches {mc.LAUNCHES}; "
            f"batches computed {runs[tag]['computed']}, skipped "
            f"{runs[tag]['skipped']}; timers {_stats(stats_path)['timers_s']}; "
            f"TSV == phase 4's: {got == want}")
        _need_launches({"match_full": mc.LAUNCHES}, f"checkpointed match_trie ({tag})")
        if got != want:
            raise AssertionError(f"checkpointed match_trie ({tag}) differs")

    with _env(SCTAG_STATS=str(stats_path)):
        _run("plain")
    with _env(SCTAG_CHECKPOINT_DIR=str(ckpt), SCTAG_STATS=str(stats_path),
              SCTAG_CHECKPOINT_BATCH=str(MATCH_CKPT_BATCH)):
        _run("cold")
        parts = sorted(ckpt.glob("match_trie-*/part*.tsv"))
        parts[2].unlink()
        _run("resume")
    if (len(parts), runs["cold"]["computed"]) != (4, 4) or \
            (runs["resume"]["computed"], runs["resume"]["skipped"]) != (1, 3):
        raise AssertionError(f"checkpointed match_trie batch counts: {runs}")
    return runs


def _runner_sample(tmp: pathlib.Path, n_reads: int, n_wl: int):
    """A --from-lr-only sample like tests/test_pipeline.py's: reads of
    prefix + adapter + whitelist barcode + tail, 40% reverse strand; the
    adapter carries 0-4 substitutions and the barcode 0-2, so some reads
    pass the host prefilters and reach K6 and K1."""
    rng = np.random.default_rng(17)
    wl = sorted({_dna(rng, 16) for _ in range(n_wl)})
    wl_path = tmp / "runner_wl.txt.gz"
    wl_path.write_bytes(gzip.compress(("\n".join(wl) + "\n").encode()))

    def _subst(s: str, k: int) -> str:
        b = list(s)
        for at in rng.integers(0, len(b), k):
            b[at] = "ACGT"[int(rng.integers(4))]
        return "".join(b)

    recs = []
    for i in range(n_reads):
        seq = (_dna(rng, int(rng.integers(3, 10)))
               + _subst(ADAPTER, int(rng.integers(0, 5)))
               + _subst(wl[int(rng.integers(len(wl)))], int(rng.integers(0, 3)))
               + _dna(rng, int(rng.integers(30, 80))))
        if rng.random() < 0.4:
            seq = _rev_compl(seq)
        recs.append(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp / "runner.fastq"
    fq.write_text("".join(recs))
    return fq, wl_path


def check_runner(tmp: pathlib.Path, n_reads: int = RUNNER_READS,
                 n_wl: int = RUNNER_WHITELIST) -> dict:
    """Phase 6d: the runner's --from-lr-only DAG (extract_lr_bc ->
    extract_sr_bc_from_lr -> match_trie) on the card and under
    SCTAG_DEVICE=cpu: the three artifacts equal; a second call skips every
    rule. Returns the card run's launches and both walls."""
    import torch

    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.pipeline.runner import run_config
    from sctagger_tpu_torch.tools import gpu_line

    fq, wl = _runner_sample(tmp, n_reads, n_wl)
    names = ["lr_bc", "sr_bc_from_lr", "lr_bc_from_lr_matches"]
    arts, res = {}, {}
    for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
        cfg = {"outpath": str(tmp / f"runner_{tag}"),
               "samples": {"s1": {"whiltlist": str(wl), "lr_fastqs": [str(fq)]}}}
        with _env(SCTAG_DEVICE=dev):
            mc.LAUNCHES = ac.LAUNCHES = ac.MASK_LAUNCHES = 0
            t0 = time.perf_counter()
            run_config(cfg, threads=8, from_lr_only=True)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"match_full": mc.LAUNCHES, "adapter_scan": ac.LAUNCHES,
                        "adapter_mask": ac.MASK_LAUNCHES}
            root = tmp / f"runner_{tag}" / "s1"
            arts[tag] = {n: gzip.decompress((root / f"s1.{n}.tsv.gz").read_bytes())
                         for n in names}
            res[tag] = {"wall_s": wall, "launches": launches}
            log(f"[runner] --from-lr-only on {dev}: {n_reads} reads, {n_wl} barcodes, "
                f"wall {wall:.3f}s ({gpu_line()}); launches {launches}; rows "
                f"{[len(a.splitlines()) for a in arts[tag].values()]}")
            if dev == "cuda":
                _need_launches({k: launches[k] for k in ("match_full", "adapter_scan")},
                               "the runner")
                mtimes = {q: q.stat().st_mtime_ns for q in root.iterdir()}
                mc.LAUNCHES = ac.LAUNCHES = 0
                run_config(cfg, threads=8, from_lr_only=True)
                skipped = ({q: q.stat().st_mtime_ns for q in root.iterdir()} == mtimes
                           and mc.LAUNCHES == ac.LAUNCHES == 0)
                log(f"[runner] second call skipped every rule: {skipped}")
                if not skipped:
                    raise AssertionError("the runner's second call reran a rule")
    same = arts["card"] == arts["cpu"]
    log(f"[runner] card artifacts == CPU artifacts: {same}")
    if not same or not arts["card"]["lr_bc_from_lr_matches"]:
        raise AssertionError("the runner on the card differs from the CPU")
    return res


def check_profile(main: dict, tmp: pathlib.Path) -> dict:
    """Phase 6e: SCTAG_PROFILE around a match_trie run on the first 1,024
    flagship rows: the Chrome trace must exist and name the match_full
    kernel (its CUDA kernel match_sweep, its range sctag_match_full)."""
    from sctagger_tpu_torch import cli
    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.stages import match_trie

    prof = tmp / "prof"
    mc.LAUNCHES = 0
    with _env(SCTAG_PROFILE=str(prof)):
        match_trie.run(cli.parse_args(
            ["match_trie", "-lr", str(main["head"]), "-sr", str(main["sr"]),
             "-mr", "2", "-o", str(tmp / "out_prof.tsv")]), device="cuda")
    traces = sorted(prof.glob("match_trie.*.pt.trace.json"))
    events = json.loads(traces[0].read_text())["traceEvents"] if traces else []
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "match_sweep" in e.get("name", "")]
    ranges = [e for e in events if e.get("name") == "sctag_match_full"]
    names = sorted({e.get("name", "")[:60] for e in events if e.get("cat") == "kernel"})
    log(f"[profile] trace {traces[0].name if traces else None}: {len(events)} events, "
        f"match_sweep kernel events {len(kernels)} "
        f"({sum(e.get('dur', 0) for e in kernels):.1f} us), sctag_match_full ranges "
        f"{len(ranges)}, launches {mc.LAUNCHES}; kernel names {names[:8]}")
    if not kernels or not ranges:
        raise AssertionError("the profiler trace does not name the match_full kernel")
    return {"kernel_events": len(kernels), "ranges": len(ranges)}


# A host of a multi-host run: the port's CLI, then its launch counts on a
# last stdout line of its own.
_HOST = (
    "import json, sys\n"
    "from sctagger_tpu_torch.cli import main\n"
    "from sctagger_tpu_torch.ops import adapter_cuda as ac, match_cuda as mc\n"
    "main(sys.argv[1:])\n"
    "print('LAUNCHES ' + json.dumps({'match_full': mc.LAUNCHES, "
    "'adapter_scan': ac.LAUNCHES, 'adapter_mask': ac.MASK_LAUNCHES}), flush=True)\n"
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_hosts(tag: str, argv: list, tmp: pathlib.Path, transport: str,
               n_hosts: int = 2, timeout: int = 600, **env) -> dict:
    """``argv`` at --n-hosts ``n_hosts``: one process per host, all on this
    card, started together; ``transport`` fs or gloo (--coordinator on a
    free local port). Returns the wall (launch of the first to exit of the
    last) and each host's launches and stage timers."""
    extra = []
    if transport == "gloo":
        extra = ["--coordinator", f"127.0.0.1:{_free_port()}"]
    stats = [tmp / f"stats_mh_{tag}_h{h}.jsonl" for h in range(n_hosts)]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _HOST, *map(str, argv), "--n-hosts", str(n_hosts),
             "--host-id", str(h), *extra],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT), "SCTAG_STATS": str(stats[h]),
                 "SCTAG_SYNC_TIMEOUT": str(timeout), **env},
        )
        for h in range(n_hosts)
    ]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    wall = time.perf_counter() - t0
    if any(q.returncode for q in procs):
        raise AssertionError(f"multi-host {tag} failed: "
                             + "\n".join(e[-3000:] for _, e in outs))
    launches = [json.loads(o.strip().splitlines()[-1].split(" ", 1)[1]) for o, _ in outs]
    timers = [_stats(q)["timers_s"] for q in stats]
    return {"wall_s": wall, "launches": launches, "timers": timers}


def multihost_path(tmp: pathlib.Path, match: dict, lr: dict, sr: dict,
                   alt: dict) -> dict:
    """Phase 7a: every stage at --n-hosts 2 over fs, and extract_lr_bc and
    the alt stage over gloo, two processes on this card each; every output
    equals the single-host output of phases 4 and 6."""
    from sctagger_tpu_torch.tools import gpu_line

    want_lr = gzip.decompress(lr["out"].read_bytes())
    runs = [
        ("match_trie", "fs", ["match_trie", "-lr", match["lr"], "-sr", match["sr"],
                              "-mr", "2"], ".tsv", match["out"].read_bytes(), {}),
        ("extract_lr_bc", "fs", ["extract_lr_bc", "-r", lr["fq"]], ".tsv.gz",
         want_lr, {}),
        ("extract_sr_bc", "fs", ["extract_sr_bc", "-i", sr["bam"]], ".tsv.gz",
         sr["want"], {}),
        ("extract_sr_bc_from_lr", "fs", ["extract_sr_bc_from_lr", "-i", alt["lr"],
                                         "-wl", alt["wl"]], ".tsv.gz", alt["want"],
         {}),
        ("extract_lr_bc", "gloo", ["extract_lr_bc", "-r", lr["fq"]], ".tsv.gz",
         want_lr, {}),
        ("extract_sr_bc_from_lr", "gloo", ["extract_sr_bc_from_lr", "-i", alt["lr"],
                                           "-wl", alt["wl"]], ".tsv.gz", alt["want"],
         {}),
    ]
    out = {}
    for stage, transport, argv, ext, want, env in runs:
        tag = f"{stage}_{transport}"
        dst = tmp / f"mh_{tag}{ext}"
        r = _run_hosts(tag, [*argv, "-o", dst], tmp, transport, **env)
        got = gzip.decompress(dst.read_bytes()) if ext == ".tsv.gz" else dst.read_bytes()
        same = got == want
        log(f"[multihost] {stage} over {transport}, 2 hosts on one card: wall "
            f"{r['wall_s']:.3f}s ({gpu_line()}); launches per host {r['launches']}; "
            f"host timers {r['timers']}; output == single-host: {same} "
            f"({len(got.splitlines())} rows)")
        if not same or not want:
            raise AssertionError(f"multi-host {stage} over {transport} differs")
        if stage in ("match_trie", "extract_lr_bc"):
            key = "match_full" if stage == "match_trie" else "adapter_scan"
            _need_launches({f"{key} (host {h})": n[key]
                            for h, n in enumerate(r["launches"])}, f"multi-host {tag}")
        out[tag] = r
    return out


def grid_path() -> dict:
    """Phase 7b: the device grid on this card: dryrun_multichip(2) on two
    slices of it (and at every card where there are several); the K1 chunk
    at data 2 and model 2 and K6 SLOTS at data 2, each == its one-device
    launch, timed."""
    import torch

    import bench
    from sctagger_tpu_torch import entry
    from sctagger_tpu_torch.models.matcher import MatchContext
    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.ops import match_cuda as mc
    from sctagger_tpu_torch.parallel import mesh as pm
    from sctagger_tpu_torch.tools import cuda_ms, gpu_line, roofline

    res = {}
    sizes = [(2, {"SCTAG_VIRTUAL_DEVICES": "2"})]
    if torch.cuda.device_count() > 1:
        sizes.append((torch.cuda.device_count(), {}))
    for n, env in sizes:
        mc.LAUNCHES = ac.LAUNCHES = ac.MASK_LAUNCHES = 0
        t0 = time.perf_counter()
        with _env(**env):
            summary = entry.dryrun_multichip(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"match_full": mc.LAUNCHES, "adapter_scan": ac.LAUNCHES,
                    "adapter_mask": ac.MASK_LAUNCHES}
        log(f"[grid] dryrun_multichip({n}) {'virtual' if env else 'cards'}: "
            f"{wall:.1f}s, {summary}; launches {launches}")
        _need_launches({k: launches[k] for k in ("match_full", "adapter_scan")},
                       f"dryrun_multichip({n})")
        res[f"dryrun_{n}"] = wall

    dev = torch.device("cuda")
    segs, barcodes = bench.make_inputs(16_384, N_BARCODES, seed=0)
    ctx = MatchContext(barcodes)
    seg = torch.from_numpy(mc.prep_segs_T(_encode(segs, 24), 24)).to(dev)
    peq = torch.from_numpy(mc.prep_peq_cols(ctx.peq(), bp=2 * mc.DEF_BP)).to(dev)
    with _env(SCTAG_VIRTUAL_DEVICES="2"):
        grids = {"data 2": pm.make_mesh(2), "model 2": pm.make_mesh(2, model_parallel=2)}
    one = mc.match_full(seg, peq, 16)
    ms_one = cuda_ms(lambda: mc.match_full(seg, peq, 16), reps=10)
    for name, mesh in grids.items():
        got = pm.shard_match_full_mp(mesh, seg, peq, 16)
        err = _err(got, one)
        ms = cuda_ms(lambda: pm.shard_match_full_mp(mesh, seg, peq, 16), reps=10)
        log(f"[grid] K1 chunk {seg.shape[1]} reads x {peq.shape[0]} patterns at "
            f"{name}: {ms:.3f} ms vs one launch {ms_one:.3f} ms, max_abs_err={err} "
            f"({gpu_line()})")
        if err:
            raise AssertionError(f"K1 on the grid ({name}) differs from one launch")
        res[f"k1 {name}"] = (ms, ms_one)
    args = roofline.adapter_chunk(dev, n=131_072)
    one = ac.adapter_scan(*args)
    got = pm.shard_adapter_scan(grids["data 2"], *args)
    err = _err(got, one)
    ms_one = cuda_ms(lambda: ac.adapter_scan(*args), reps=20)
    ms = cuda_ms(lambda: pm.shard_adapter_scan(grids["data 2"], *args), reps=20)
    log(f"[grid] K6 SLOTS on 131,072 reads at data 2: {ms:.3f} ms vs one launch "
        f"{ms_one:.3f} ms, max_abs_err={err} ({gpu_line()})")
    if err:
        raise AssertionError("K6 SLOTS on the grid differs from one launch")
    res["k6 data 2"] = (ms, ms_one)
    return res


def kernel_rows(roof: dict, timing, k6, k6_mask, variants, k7, match_launches,
                res_lr, variant_launches, micro_launches) -> list[dict]:
    """The kernels line: one row per kernel with its launches on the main
    path, the checks' numbers (``ms`` per call between CUDA events, every
    row alike) and two bounds of the timed launch, each the larger of its
    bytes over the HBM rate and its work over a rate: bound_ms, source ops
    over this run's measured int32 ceiling; and issue_bound_ms, the
    instructions the function needs (roofline.issue_per_cell: the fewer of
    its source ops and its compiled loop's hot path, per cell, times the
    cells) over the card's issue rate at clocks.max.sm. No single PyTorch
    call computes any of these functions (library_ms null). Fails when a
    share (bound / ms) passes SHARE_LIMIT."""
    from sctagger_tpu_torch.ops import micro_cuda as mic
    from sctagger_tpu_torch.tools import roofline

    sass = roof["sass_loops"]
    if not sass or any(v is None for v in sass.values()):
        raise AssertionError(f"no SASS loop count for some kernel: {sass}")
    ceiling, iss = roof["ceiling"]["ops_per_s"], roof["issue"]

    def bounds(ms, ops, instr, nbytes) -> dict:
        by_bytes = nbytes / roofline.HBM_BYTES_PER_S
        by_issue = 1e-3 * roofline.issue_bound_ms(instr, iss["sms"], iss["max_sm_mhz"])
        b, i = max(ops / ceiling, by_bytes), max(by_issue, by_bytes)
        return {"bound_ms": 1e3 * b, "bound_by": "operations" if b > by_bytes else "bytes",
                "issue_bound_ms": 1e3 * i,
                "issue_bound_by": "operations" if i > by_bytes else "bytes",
                "share": 1e3 * b / ms, "issue_share": 1e3 * i / ms}

    def counts(name, ops_per_cell) -> dict:
        return {"ops_per_cell": ops_per_cell,
                "issue_per_cell": roofline.issue_per_cell(sass, name, ops_per_cell),
                "sass_per_cell": roofline.sass_per_cell(sass, name),
                **({"sass_hot_per_cell": sass[f"{name}_hot"] / roofline.CELLS_PER_TRIP[name]}
                   if f"{name}_hot" in sass else {})}

    def row(name, source, replaces, n, stats, cells, ops_per_cell, **extra):
        c = counts(name, ops_per_cell)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
                "plain_ms": stats["plain_ms"],
                **bounds(stats["ms"], cells * ops_per_cell, cells * c["issue_per_cell"],
                         stats["bytes"]),
                "library_ms": None, **c, **extra}

    match_ops = roofline.MATCH_OPS_PER_CELL
    mask_ops = roofline.MASK_OPS_PER_CHAR_STRAND
    mask_issue = roofline.issue_per_cell(sass, "adapter_mask", mask_ops)
    full = k6_mask["full"]
    ceil = roof["ceiling"]
    best = ceil["best_chains"]
    k7_at = ceil["by_chains"][best]
    k7_stats = {"max_abs_err": k7["max_abs_err"], "ms": k7_at["ms"],
                "plain_ms": k7["plain_ms"][best], "bytes": 2 * 4 * k7_at["elements"]}
    k7_chain_iters = k7_at["elements"] * ceil["iters"] * ceil["grid"] * best
    k7_issue = min(mic.OPS_PER_ITER, sass[f"micro_{best}"] / best)
    dynls_issue = roofline.issue_per_cell(sass, "match_full_dynls", match_ops)
    rows = [
        row("match_full", KERNEL_SRC, REPLACES, match_launches, timing, timing["cells"],
            match_ops, dynls={"ms": timing["dynls_ms"], "issue_per_cell": dynls_issue,
                              **bounds(timing["dynls_ms"], timing["cells"] * match_ops,
                                       timing["cells"] * dynls_issue, timing["bytes"])}),
        row("adapter_scan", ADAPTER_SRC, ADAPTER_REPLACES, res_lr["launches"], k6,
            2 * k6["chars"], roofline.ADAPTER_OPS_PER_CHAR_STRAND),
        row("adapter_mask", ADAPTER_SRC, ADAPTER_REPLACES, res_lr["mask_launches"],
            k6_mask, 2 * k6_mask["chars"], mask_ops, reads=k6_mask["reads"],
            nseg=k6_mask["nseg"], device_ms=k6_mask["device_ms"],
            floor_ms=k6_mask["floor"]["ms"], floor_device_ms=k6_mask["floor"]["device_ms"],
            at_4096={"reads": full["reads"], "nseg": full["nseg"], "ms": full["ms"],
                     "device_ms": full["device_ms"], "plain_ms": full["plain_ms"],
                     **bounds(full["ms"], 2 * full["chars"] * mask_ops,
                              2 * full["chars"] * mask_issue, full["bytes"])}),
    ] + [row(name, KERNEL_SRC, VARIANT_REPLACES[name], variant_launches[name],
             variants[name], variants[name]["cells"], match_ops)
         for name in VARIANT_REPLACES] + [
        {"name": "myers_micro", "route": "cuda", "source": MICRO_SRC,
         "replaces": MICRO_REPLACES, "launches": micro_launches,
         "max_abs_err": k7_stats["max_abs_err"], "ms": k7_stats["ms"],
         "plain_ms": k7_stats["plain_ms"],
         **bounds(k7_stats["ms"], k7_chain_iters * mic.OPS_PER_ITER,
                  k7_chain_iters * k7_issue, k7_stats["bytes"]),
         "library_ms": None, "chains": best, "ops_per_chain_iter": mic.OPS_PER_ITER,
         "issue_per_chain_iter": k7_issue,
         "sass_per_chain_iter": sass[f"micro_{best}"] / best},
    ]
    shapes = rows + [{"name": "match_full_dynls", **rows[0]["dynls"]},
                     {"name": "adapter_mask@4096", **rows[2]["at_4096"]}]
    over = [(r["name"], k, r[k]) for r in shapes for k in ("share", "issue_share")
            if r[k] > SHARE_LIMIT]
    if over:
        raise AssertionError(f"a share above {SHARE_LIMIT:.0%} (a wrong count): {over}")
    return rows


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, default=1_048_576,
                    help="LR segments in the match_trie run (>= 262144)")
    ap.add_argument("--lr-reads", type=int, default=1_000_000,
                    help="long reads in the extract_lr_bc run (>= 250000)")
    args = ap.parse_args(argv)
    if args.segments < 262_144:
        ap.error("--segments must be >= 262144")
    if args.lr_reads < 250_000:
        ap.error("--lr-reads must be >= 250000")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not all((ROOT / f).exists() for f in (KERNEL_SRC, ADAPTER_SRC, MICRO_SRC,
                                             "bench.py", "tools/measure_reference.py",
                                             "tests/bamgen.py")):
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from sctagger_tpu_torch.tools import gpu_line, roofline

    gpu = gpu_line()
    log(f"[device] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    from sctagger_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}, one per source in "
        f"parallel: {time.perf_counter() - t0:.1f}s\n{_build.BUILD_LOG.strip()}")
    for name in _build._SRCS:
        _build.load(name)
    t0 = time.perf_counter()
    _build.build_host()
    log(f"[build] host library: {time.perf_counter() - t0:.1f}s")

    timing = check_kernels()
    k5_escalation = check_device_paths()
    k6 = check_adapter_kernel()
    k6_mask = check_adapter_mask()
    variants = check_match_variants()
    k7 = check_micro()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        res = main_path(args.segments, tmp)
        check_match_checkpoint(res, tmp)
        check_profile(res, tmp)
        res_lr = stage1_main_path(args.lr_reads, tmp)
        check_stage1_output(tmp)
        res_sr = check_sr_stage(tmp)
        res_alt = check_alt_stage(tmp)
        check_runner(tmp)
        t7 = time.perf_counter()
        multihost_path(tmp, res, res_lr, res_sr, res_alt)
        t7a = time.perf_counter() - t7
        t7 = time.perf_counter()
        grid_path()
        t7b = time.perf_counter() - t7
    log(f"[phase 7] multi-host {t7a:.1f}s + grid {t7b:.1f}s = {t7a + t7b:.1f}s")
    k4_entry = entry_path()
    prof = profile_path()
    roof = roofline_path()
    launches = {"match_min": k4_entry, "match_best": k5_escalation,
                "match_ties": prof["match_ties"]}
    kernels = kernel_rows(roof["roofline"], timing, k6, k6_mask, variants, k7,
                          res["launches"], res_lr, launches, roof["launches"])
    main_chunk = k6["main_chunk"]
    ceiling = roof["roofline"]["ceiling"]["ops_per_s"]
    log(f"[k6] SLOTS at 131,072 reads: {main_chunk['ms']:.3f} ms, bound "
        f"{1e3 * 2 * main_chunk['chars'] * roofline.ADAPTER_OPS_PER_CHAR_STRAND / ceiling:.3f}"
        f" ms ({gpu})")
    log(f"[total] chip_smoke: {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
