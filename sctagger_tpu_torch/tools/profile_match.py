"""Profile of the match pipeline's device passes on the card (port of
tools/profile_match.py).

    python -m sctagger_tpu_torch.tools.profile_match

On the flagship workload (bench.make_inputs: 131,072 segments against
25,000 barcodes, i.e. 50,000 patterns padded to 50,176; bl 16, segments
padded to 32 positions) it times:

  host      pattern + Peq build, segment encode, position-major layout
  pass 1    match_min (K4) over all 131,072 segments
  pass 2    match_best (K5) on the first PASS2_CHUNK segments, then
            _topk_hits (k = 16) against the pass-1 minima, then the copy of
            the hit ids to the host; and the fused alternative, match_ties
            (K3) at the same minima

Device times are CUDA-event ms per call (mean of 3 after one warm-up); host
times are wall-clock ms. Prints the card's name and power limit, one line
per step, and a JSON object of the numbers as the last line. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs

from ..models.matcher import PASS2_CHUNK, MatchContext, _topk_hits
from ..ops import match_cuda as mc
from . import cuda_ms, gpu_line, make_inputs, require_cuda

N_SEGS = 131_072
BL = 16
LS = 32
TOPK = 16
REPS = 3


def _line(label: str, ms: float) -> None:
    print(f"{label:44s} {ms:10.3f} ms", flush=True)


def run(dev, reps: int = REPS) -> dict:
    """Time every step once per rep; returns ms by step plus the shapes."""
    segs, barcodes = make_inputs(N_SEGS)
    res: dict = {"segments": N_SEGS, "barcodes": len(barcodes)}

    t0 = time.perf_counter()
    ctx = MatchContext(barcodes)
    peq_pm = mc.prep_peq_cols(ctx.peq())
    res["host_patterns_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    codes, _ = encode_seqs(segs, pad_to=LS, table=LENIENT_TABLE)
    res["host_encode_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    seg_T = mc.prep_segs_T(codes, ls=LS)
    res["host_layout_ms"] = (time.perf_counter() - t0) * 1e3
    for k in ("host_patterns_ms", "host_encode_ms", "host_layout_ms"):
        _line(k, res[k])

    seg_d = torch.from_numpy(seg_T).to(dev)
    peq_d = torch.from_numpy(peq_pm).to(dev)
    p_pad = peq_d.shape[0]
    res["padded_patterns"] = p_pad

    ms = cuda_ms(lambda: mc.match_min(seg_d, peq_d, BL), reps)
    pairs = N_SEGS * p_pad
    res["pass1_min_ms"] = ms
    res["pass1_pairs_per_s"] = pairs / (ms * 1e-3)
    _line(f"pass 1 match_min {N_SEGS}x{p_pad} (ls {LS})", ms)
    print(f"  -> {pairs / ms / 1e6:.2f} G pair/s; "
          f"{pairs * LS / ms / 1e9:.3f} T cell/s", flush=True)
    mins = mc.match_min(seg_d, peq_d, BL)[0]

    seg2 = torch.from_numpy(mc.prep_segs_T(codes[:PASS2_CHUNK], ls=LS, br=1)).to(dev)
    target = mins[: seg2.shape[1]].contiguous()
    n_pat = ctx.pat_codes.shape[0]
    ms = cuda_ms(lambda: mc.match_best(seg2, peq_d, BL), reps)
    res["pass2_best_ms"] = ms
    _line(f"pass 2 match_best {PASS2_CHUNK}x{p_pad}", ms)
    best = mc.match_best(seg2, peq_d, BL)
    ms = cuda_ms(lambda: _topk_hits(best, target, n_pat, TOPK), reps)
    res["pass2_topk_ms"] = ms
    _line(f"pass 2 _topk_hits (k={TOPK})", ms)
    ms = cuda_ms(lambda: _topk_hits(best, target, n_pat, TOPK)[1].cpu(), reps)
    res["pass2_topk_to_host_ms"] = ms
    _line("pass 2 _topk_hits + copy of the ids to host", ms)
    per_chunk = res["pass2_best_ms"] + res["pass2_topk_to_host_ms"]
    print(f"  -> pass 2 per chunk {per_chunk:.3f} ms = "
          f"{PASS2_CHUNK / (per_chunk * 1e-3):.0f} segs/s if all escalated",
          flush=True)
    ms = cuda_ms(lambda: mc.match_ties(seg2, peq_d, target, BL), reps)
    res["pass2_ties_ms"] = ms
    _line(f"pass 2 fused match_ties {PASS2_CHUNK}x{p_pad}", ms)
    return res


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    dev = require_cuda()
    gpu = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({gpu})", flush=True)
    res = run(dev)
    res["gpu"] = gpu
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
