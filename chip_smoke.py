#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sctagger_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--segments N]

Phases, each fatal on failure:
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile csrc/*.cu with nvcc (sm_90a) from this checkout, and
     the host library (sctagger_tpu/native, g++) the TSV I/O and the
     prefilter use.
  3. kernel vs plain: the match kernel (match_full / match_full_dynls)
     against its plain torch version on the card, exact equality, at
     m in {16, 31, 32}, uniform and ragged lengths, a read with > 8 ties,
     and one 16,384-read x 50,000-pattern chunk of 24 bp segments (timed);
     then match_segments on the card against the CPU with > 8 ties and
     with 40 bp barcodes (tie escalation and the multi-word path).
  4. main path: `match_trie` through sctagger_tpu_torch.cli.main on the
     flagship workload (bench.make_inputs: N segments x 25,000 barcodes,
     mr=2), counting kernel launches.
  5. output check: the first 4,096 LR rows rerun through the plain path on
     the CPU must give byte-identical rows.

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
    """Phases 4 and 5."""
    import torch

    import bench
    from sctagger_tpu_torch import cli
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, default=1_048_576,
                    help="LR segments in the main-path run (>= 262144)")
    args = ap.parse_args(argv)
    if args.segments < 262_144:
        ap.error("--segments must be >= 262144")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (ROOT / KERNEL_SRC).exists() or not (ROOT / "bench.py").exists():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    gpu = gpu_line()
    log(f"[device] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    from sctagger_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f}s\n{_build.BUILD_LOG.strip()}")
    _build.load()
    t0 = time.perf_counter()
    _build.build_host()
    log(f"[build] host library: {time.perf_counter() - t0:.1f}s")

    timing = check_kernels()
    check_device_paths()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        res = main_path(args.segments, pathlib.Path(tmp))

    log(json.dumps({"kernels": [{
        "name": "match_full",
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": REPLACES,
        "launches": res["launches"],
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
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
