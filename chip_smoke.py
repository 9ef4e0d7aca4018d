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
       chunk of 1,000-3,000 bp reads (timed).
  4. main paths, each with every launch count set to 0 just before it:
     - `match_trie` through sctagger_tpu_torch.cli.main on the flagship
       workload (bench.make_inputs: N segments x 25,000 barcodes, mr=2);
     - `extract_lr_bc` through sctagger_tpu_torch.cli.main on N long reads
       (tools/measure_reference.make_lr_fastq: 1,000-3,000 bp, the 22 bp
       adapter at 0-19 with 5% substitutions).
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
import subprocess
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
ADAPTER = "CTACACGACGCTCTTCCGATCT"
LR_CHECK_READS = 20_000
REPLACES = (
    "sctagger_tpu/ops/match_pallas.py:207 (_match_full_kernel via "
    "match_full_tpu :357) + :260 (_match_full_dynls_kernel via "
    "match_full_dynls_tpu :316)"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


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
    ms = _cuda_ms(lambda: mc.match_full(seg, peq, 16), reps=10)
    plain_ms = _cuda_ms(lambda: mc.match_full_ref(seg, peq, 16), reps=2)
    log(f"[kernel] flagship chunk: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"({gpu_line()})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_device_paths() -> None:
    """match_segments on the card == on the CPU where the card runs plain
    torch: tie-overflow escalation (bl 16) and the multi-word path (bl 40)."""
    from sctagger_tpu_torch.models.matcher import match_segments

    rng = np.random.default_rng(2)
    for m, ls in ((16, 24), (40, 48)):
        ctx, segs = _case(rng, 2000, 200, m, ls, ragged=True)
        res = {}
        for dev in ("cuda", "cpu"):
            r = match_segments(segs, ctx.barcodes, 2, ctx=ctx, device=dev)
            res[dev] = (r.rids.tolist(), r.dists.tolist(), r.tie_counts.tolist(),
                        [r.ties_of(i).tolist() for i in range(r.rids.size)])
        over = sum(c > 8 for c in res["cpu"][2])
        log(f"[paths] bl={m}: {len(res['cpu'][0])} matched, {over} with > 8 "
            f"ties; card == cpu: {res['cuda'] == res['cpu']}")
        if res["cuda"] != res["cpu"] or over == 0:
            raise AssertionError(f"match_segments differs on the card (bl={m})")


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
    mc.LAUNCHES = 0
    ac.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mc.LAUNCHES
    st = json.loads(stats_path.read_text().splitlines()[-1])
    c = st["counters"]
    log(f"[main] match_trie wall {wall:.3f}s = {n_segments / wall:.1f} "
        f"segments/s ({gpu_line()}); stage timers {st['timers_s']}")
    log(f"[main] prefilter-resolved {int(c['prefilter_resolved'])}, "
        f"kernel reads {int(c['device_reads'])} in "
        f"{int(c['device_chunks'])} chunks, kernel launches {launches}, "
        f"matched {int(c['matched'])}")
    if launches == 0:
        raise AssertionError("the main path launched no kernel")

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
    return {"launches": launches, "wall_s": wall}


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


def _k6_rows(reads, adapter: str, sort: bool = False):
    """One kernel chunk of ``reads`` on the card: (text, lens, peq, m)."""
    import torch

    from sctagger_tpu.core.packing import encode_str
    from sctagger_tpu_torch.ops import adapter_cuda as ac
    from sctagger_tpu_torch.ops.myers import build_peq_multi

    lens = np.array([len(r) for r in reads])
    idx = np.argsort(lens, kind="stable") if sort else np.arange(len(reads))
    text, ln, junk = ac.pack_chunk(reads, idx, int(lens.max()))
    assert not junk.any()
    peq = ac.prep_peq(build_peq_multi(np.stack(
        [encode_str(adapter), encode_str(_rev_compl(adapter))])))
    dev = torch.device("cuda")
    return (torch.from_numpy(text).to(dev), torch.from_numpy(ln).to(dev), peq,
            len(adapter))


def k6_timed_chunk(rng):
    """One realistic K6 chunk: 16,384 length-sorted reads of 1,000-3,000 bp
    with the adapter at 0-19 under 5% substitutions (the main path's
    reads)."""
    reads = []
    for _ in range(16_384):
        t = _dna(rng, int(rng.integers(1000, 3000)))
        a = "".join(c if rng.random() >= 0.05 else "ACGT"[int(rng.integers(4))]
                    for c in ADAPTER)
        p = int(rng.integers(0, 20))
        reads.append(t[:p] + a + t[p:])
    return _k6_rows(reads, ADAPTER, sort=True)


def check_adapter_kernel() -> dict:
    """Phase 3b: K6 == adapter_scan_ref on the card (full rows, exact), then
    the timed realistic chunk."""
    import torch

    from sctagger_tpu_torch.ops import adapter_cuda as ac

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

    args = k6_timed_chunk(rng)
    got = ac.adapter_scan(*args)
    ref = ac.adapter_scan_ref(*args)
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    worst = max(worst, err)
    if not torch.equal(got, ref):
        raise AssertionError("K6 disagrees with adapter_scan_ref (timed chunk)")
    ms = _cuda_ms(lambda: ac.adapter_scan(*args), reps=20)
    plain_ms = _cuda_ms(lambda: ac.adapter_scan_ref(*args), reps=1)
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
    if not all((ROOT / f).exists() for f in (KERNEL_SRC, ADAPTER_SRC, "bench.py")):
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
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
    check_device_paths()
    k6 = check_adapter_kernel()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        res = main_path(args.segments, pathlib.Path(tmp))
        res_lr = stage1_main_path(args.lr_reads, pathlib.Path(tmp))
        check_stage1_output(pathlib.Path(tmp))

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
