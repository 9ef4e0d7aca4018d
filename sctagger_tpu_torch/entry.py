"""Single-device entry point of the port (port of __graft_entry__.entry).

``entry()`` returns ``(fn, example_args)``: ``fn`` is one forward step of
the flagship matcher, the per-read min distance over all patterns
(``match_min``: the K4 kernel on a CUDA device, its plain version on the
CPU), and the arguments are a toy problem on ``runtime.default_device()``:
64 random 24 bp segments padded to 32 positions against 32 random 16 bp
barcodes, made with numpy from seed 0 exactly as the JAX package's
``_toy_problem`` makes them. ``fn(*example_args)[0, :64]`` equals the JAX
``entry()`` output.

    python -m sctagger_tpu_torch.entry

prints that output. The multi-device dry run (``dryrun_multichip``) comes
with the multi-GPU port (ROADMAP Queue A6).
"""

from __future__ import annotations

import numpy as np
import torch

from sctagger_tpu.core.packing import LENIENT_TABLE, encode_seqs

from .ops.match_cuda import match_min, prep_peq_cols, prep_segs_T
from .ops.myers import build_peq_multi
from .runtime import default_device

BL = 16  # barcode length of the toy problem
READ_BLOCK = 128  # read-axis padding of the example arguments


def _toy_problem(n_segs: int = 64, n_pats: int = 32, ls: int = 32):
    """(n_segs, ls) uint8 segment codes and the (5, n_pats) int32 Peq."""
    rng = np.random.default_rng(0)
    segs = ["".join(rng.choice(list("ACGT"), size=24)) for _ in range(n_segs)]
    bcs = ["".join(rng.choice(list("ACGT"), size=BL)) for _ in range(n_pats)]
    seg_codes, _ = encode_seqs(segs, pad_to=ls, table=LENIENT_TABLE)
    peq = build_peq_multi(encode_seqs(bcs, pad_to=BL, table=LENIENT_TABLE)[0])
    return seg_codes, peq


def entry():
    """(fn, example_args): one forward step and its arguments on the
    default device. ``fn(seg_T, peq_pm)`` returns (1, R_pad) int32."""
    dev = default_device()
    seg_codes, peq = _toy_problem()
    seg_T = prep_segs_T(seg_codes, ls=seg_codes.shape[1], br=READ_BLOCK)
    args = (torch.from_numpy(seg_T).to(dev), torch.from_numpy(prep_peq_cols(peq)).to(dev))

    def fn(seg, pq):
        return match_min(seg, pq, BL)

    return fn, args


if __name__ == "__main__":
    fn, args = entry()
    print(fn(*args)[0, :64].tolist())
