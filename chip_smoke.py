#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sctagger_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--segments N] [--lr-reads N]

Phases, each fatal on failure:
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile csrc/*.cu with nvcc (sm_90a, one nvcc per source, in
     parallel) from this checkout, and the host library (sctagger_tpu/native,
     g++) that FASTQ/TSV I/O and the prefilters use.
  3. kernel vs plain:
     - the match kernel (match_full / match_full_dynls) against its plain
       torch version on the card, exact equality, at m in {16, 31, 32},
       uniform and ragged lengths, a read with > 8 ties, and one 16,384-read
       x 50,000-pattern chunk of 24 bp segments (timed); then
       match_segments on the card against the CPU with > 8 ties and with
       40 bp barcodes (tie escalation and the multi-word path);
     - the adapter-scan kernel (adapter_scan) against adapter_scan_ref on
       the card, exact equality of the full rows, at m in {22, 31, 32},
       uniform and ragged lengths, empty and shorter-than-m reads, reads
       with > 4 optimal ends and reads of >= 70,000 bp; then one 16,384-read
       chunk of 1,000-3,000 bp reads (timed);
     - the min, best-matrix and ties epilogues of the match kernel
       (match_min / match_best / match_ties, K4 / K5 / K3) against their
       plain versions, exact equality, at m in {16, 31, 32}, uniform and
       ragged, a few-read case that splits the pattern axis and merges, a
       one-tile case that does not, ties at K1's minima and at m; then the
       16,384-read x 50,000-pattern chunk (timed);
     - the int32 microkernel (myers_micro, K7) against micro_ref at chains
       1/2/4/8 (timed at chains 4).
  4. main paths, each with every launch count set to 0 just before it:
     - `match_trie` through sctagger_tpu_torch.cli.main on the flagship
       workload (bench.make_inputs: N segments x 25,000 barcodes, mr=2);
     - `extract_lr_bc` through sctagger_tpu_torch.cli.main on N long reads
       (tools/measure_reference.make_lr_fastq: 1,000-3,000 bp, the 22 bp
       adapter at 0-19 with 5% substitutions);
     - `entry()` (sctagger_tpu_torch.entry: K4 on the toy problem), its
       output equal to the CPU plain version's;
     - `tools.profile_match` (K4 pass 1 at 131,072 segments, K5 + top-k
       and K3 pass 2);
     - `tools.roofline` (K7 ceiling at chains 1/2/4/8, K1 and K6 read as
       shares of it), whose JSON is printed on a [roofline] line.
     check_device_paths (phase 3) also requires that the > 8-ties escalation
     at bl 16 launched match_best (K5) on the card; the `match_trie` run
     logs the reads it escalates and K5's launches there.
  5. output checks: the first 4,096 LR rows of `match_trie` rerun through the
     plain path on the CPU must give byte-identical rows; a 20,000-read
     `extract_lr_bc` run (plus reads with N and one with > 4 ends) on the
     card and on the CPU must write identical TSVs.

The line before the last is a JSON object with the kernel table; the last
line is {"ok": true, "device": {...}}. Exits nonzero, printing no result,
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_BARCODES = 25_000
HEAD_ROWS = 4096
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
REPLACES = (
    "sctagger_tpu/ops/match_pallas.py:207 (_match_full_kernel via "
    "match_full_tpu :357) + :260 (_match_full_dynls_kernel via "
    "match_full_dynls_tpu :316)"
)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    ms = cuda_ms(lambda: mc.match_full(seg, peq, 16), reps=10)
    plain_ms = cuda_ms(lambda: mc.match_full_ref(seg, peq, 16), reps=2)
    log(f"[kernel] flagship chunk: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"({gpu_line()})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
        out[name] = {"max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms}
    return out


def check_micro() -> dict:
    """Phase 3d: K7 == micro_ref on the card at every chain count (bp 8 x
    br 128, 16 iterations, grid 2), then both timed at chains 4 on a
    64 x 1,024 block, 64 iterations, one copy."""
    import torch

    from sctagger_tpu_torch.ops import micro_cuda as mic
    from sctagger_tpu_torch.tools import cuda_ms, gpu_line

    dev = torch.device("cuda")
    worst = 0
    for chains in mic.CHAINS:
        x = mic.micro_input(8, 128).to(dev)
        err = _err(mic.micro(x, 16, chains, grid=2), mic.micro_ref(x, 16, chains))
        worst = max(worst, err)
        log(f"[k7] chains={chains} bp=8 br=128 iters=16 grid=2 max_abs_err={err}")
        if err:
            raise AssertionError(f"K7 disagrees with micro_ref (chains={chains})")
    x = mic.micro_input(64, 1024).to(dev)
    ref, plain_ms = _timed_once(lambda: mic.micro_ref(x, 64, 4))
    err = _err(mic.micro(x, 64, 4), ref)
    worst = max(worst, err)
    ms = cuda_ms(lambda: mic.micro(x, 64, 4), reps=20)
    log(f"[k7] chains=4 64x1024 iters=64: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, max_abs_err={err} ({gpu_line()})")
    if err:
        raise AssertionError("K7 disagrees with micro_ref (timed block)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    st = json.loads(stats_path.read_text().splitlines()[-1])
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
    return {"launches": launches, "k5_launches": k5, "wall_s": wall}


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

    from sctagger_tpu.core.packing import encode_str
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


def check_adapter_kernel() -> dict:
    """Phase 3b: K6 == adapter_scan_ref on the card (full rows, exact), then
    the timed realistic chunk (the one tools.roofline reads K6 on)."""
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
        args = _k6_rows(reads, a)
        got = ac.adapter_scan(*args)
        ref = ac.adapter_scan_ref(*args)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max())
        worst = max(worst, err)
        over = int(((ref[1] > ac.SLOTS_K) | (ref[7] > ac.SLOTS_K)).sum())
        empty = [i for i, r in enumerate(reads) if not r]
        empty_ok = all(int(ref[0, i]) == len(a) == int(ref[6, i]) for i in empty)
        log(f"[k6] {name}: reads={len(reads)} reads>4ends={over} "
            f"max_abs_err={err} full rows equal={torch.equal(got, ref)}")
        if not torch.equal(got, ref) or not empty_ok:
            raise AssertionError(f"K6 disagrees with adapter_scan_ref ({name})")
        if "> 4 ends" in name and over == 0:
            raise AssertionError(f"no read with > 4 ends in case {name}")

    args = roofline.adapter_chunk(torch.device("cuda"))
    got = ac.adapter_scan(*args)
    ref = ac.adapter_scan_ref(*args)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    worst = max(worst, err)
    if not torch.equal(got, ref):
        raise AssertionError("K6 disagrees with adapter_scan_ref (timed chunk)")
    ms = cuda_ms(lambda: ac.adapter_scan(*args), reps=20)
    plain_ms = cuda_ms(lambda: ac.adapter_scan_ref(*args), reps=1)
    log(f"[k6] chunk of 16,384 reads x 1,000-3,000 bp ({args[0].shape[1]} "
        f"bytes/row): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"max_abs_err={err} ({gpu_line()})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _lr_stats(stats_path: pathlib.Path) -> dict:
    return json.loads(stats_path.read_text().splitlines()[-1])


def stage1_main_path(n_reads: int, tmp: pathlib.Path) -> dict:
    """Phase 4b: extract_lr_bc through the CLI on the card."""
    import gzip

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
    ac.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["extract_lr_bc", "-r", str(fq), "-o", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ac.LAUNCHES
    t = _lr_stats(stats_path)["timers_s"]
    resolved = sum(t.get(f"scan.d{d}_resolved_reads", 0) for d in range(3))
    log(f"[lr] extract_lr_bc wall {wall:.3f}s = {n_reads / wall:.1f} reads/s "
        f"({gpu_line()}); stage timers {t}")
    log(f"[lr] prefilter-resolved {int(resolved)}, prefilter-deferred "
        f"{int(t.get('scan.prefilter_deferred_reads', 0))}, kernel reads "
        f"{int(t.get('scan.kernel_reads', 0))} in "
        f"{int(t.get('scan.kernel_chunks', 0))} chunks, mask-path reads "
        f"{int(t.get('scan.mask_reads', 0))}, K6 launches {launches}")
    if launches == 0:
        raise AssertionError("the extract_lr_bc main path launched no K6")
    with gzip.open(out, "rt") as f:
        rows = [ln.split("\t") for ln in f]
    valid = sum(r[1] != "-1" for r in rows)
    log(f"[lr] {len(rows)} rows, {valid} with an adapter in range")
    if len(rows) != n_reads or any(len(r) != 4 for r in rows) or valid < n_reads // 2:
        raise AssertionError("extract_lr_bc output has the wrong shape")
    return {"launches": launches, "wall_s": wall}


def check_stage1_output(tmp: pathlib.Path) -> None:
    """Phase 5b: the whole stage on the card and on the CPU, same TSV."""
    import gzip

    import measure_reference
    from sctagger_tpu_torch import cli
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
        extract_lr_bc.run(
            cli.parse_args(["extract_lr_bc", "-r", str(fq), "-o", str(out)]),
            device=dev,
        )
        tsv[dev] = gzip.decompress(out.read_bytes())
        log(f"[check] extract_lr_bc {LR_CHECK_READS + len(extra)} reads on "
            f"{dev}: {time.perf_counter() - t0:.1f}s")
    n = tsv["cpu"].count(b"\n")
    log(f"[check] card TSV == CPU TSV: {tsv['cuda'] == tsv['cpu']} ({n} rows)")
    if tsv["cuda"] != tsv["cpu"] or n != LR_CHECK_READS + len(extra):
        raise AssertionError("extract_lr_bc on the card differs from the CPU")


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
    log(f"[roofline] int32 ceiling {ceil / 1e12:.3f} T source ops/s (best of "
        f"chains 1/2/4/8); shares of it: {shares}; K7 launches {launches}")
    if launches == 0 or not math.isfinite(ceil) or ceil <= 0 or not all(
            math.isfinite(s) and s > 0 for s in shares.values()):
        raise AssertionError("roofline gave no ceiling or no shares")
    return {"launches": launches, "roofline": res}


def main(argv=None) -> int:
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
                                             "bench.py")):
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from sctagger_tpu_torch.tools import gpu_line

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
    variants = check_match_variants()
    k7 = check_micro()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        res = main_path(args.segments, pathlib.Path(tmp))
        res_lr = stage1_main_path(args.lr_reads, pathlib.Path(tmp))
        check_stage1_output(pathlib.Path(tmp))
    k4_entry = entry_path()
    prof = profile_path()
    roof = roofline_path()
    launches = {"match_min": k4_entry, "match_best": k5_escalation,
                "match_ties": prof["match_ties"]}

    log(json.dumps({"kernels": [{
        "name": "match_full",
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": REPLACES,
        "launches": res["launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
    }, {
        "name": "adapter_scan",
        "route": "cuda",
        "source": ADAPTER_SRC,
        "replaces": ADAPTER_REPLACES,
        "launches": res_lr["launches"],
        "max_abs_err": k6["max_abs_err"],
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": VARIANT_REPLACES[name],
        "launches": launches[name],
        **variants[name],
    } for name in VARIANT_REPLACES] + [{
        "name": "myers_micro",
        "route": "cuda",
        "source": MICRO_SRC,
        "replaces": MICRO_REPLACES,
        "launches": roof["launches"],
        **k7,
    }]}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
