"""The int32 instruction-rate microkernel (csrc/myers_micro.cu): wrapper and
plain version.

Port of tools/roofline.py's ``_micro_kernel`` (K7): every element of an
int32 block runs ``chains`` independent Myers carry chains for ``iters``
iterations and stores one int32 that folds them all (see the source for the
exact op sequence). The block is repeated ``grid`` times, as the Pallas
grid repeats it; the output does not depend on ``grid``.

A wrapper given a CPU tensor runs the plain version (``micro_ref``); given a
CUDA tensor it launches the kernel on the current stream or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

OPS_PER_ITER = 21  # source ops per chain-iteration: the 20-op chain + eq ^= pv
CHAINS = (1, 2, 4, 8)
HIGH = 1 << 15

LAUNCHES = 0  # kernel launches by micro


def micro_input(bp_c: int, br: int) -> torch.Tensor:
    """The (bp_c, br) int32 block the JAX tool feeds the kernel:
    0, 1, ..., bp_c * br - 1 in row-major order."""
    return torch.from_numpy(np.arange(bp_c * br, dtype=np.int32).reshape(bp_c, br))


def micro_ops(n: int, iters: int, chains: int, grid: int) -> int:
    """Source ops of one launch over ``n`` elements, the JAX tool's count:
    grid * iters * chains * OPS_PER_ITER * n."""
    return grid * iters * chains * OPS_PER_ITER * n


def micro_ref(x: torch.Tensor, iters: int, chains: int) -> torch.Tensor:
    """Plain torch version (any device): the kernel's op sequence on int32
    tensors (wrapping adds, arithmetic right shifts, as in JAX)."""
    state = []
    for c in range(chains):
        pv = x + c
        state.append([pv, pv ^ 1, pv & 7, pv >> 3])
    for _ in range(iters):
        for st in state:
            pv, mv, score, eq = st
            xv = eq | mv
            xh = (((eq & pv) + pv) ^ pv) | eq
            ph = mv | ~(xh | pv)
            mh = pv & xh
            score = score + (((ph & HIGH) - (mh & HIGH)) >> 15)
            ph = ph << 1
            mh = mh << 1
            pv = mh | ~(xv | ph)
            mv = ph & xv
            st[:] = [pv, mv, score, eq ^ pv]
    acc = state[0][0]
    for st in state[1:]:
        acc = acc + st[0]
    return acc + state[0][2]


def micro(x: torch.Tensor, iters: int, chains: int, grid: int = 1) -> torch.Tensor:
    """Run the microkernel on ``x`` (any shape, int32, contiguous)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return micro_ref(x, iters, chains)
    if x.device.type != "cuda":
        raise ValueError(f"no microkernel for device {x.device}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous int32, got {x.dtype}")
    if chains not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}, got {chains}")
    if iters < 0 or grid < 1 or x.numel() == 0:
        raise ValueError(f"bad launch: iters={iters} grid={grid} n={x.numel()}")
    from . import _build

    out = torch.empty_like(x)
    lib = _build.load("myers_micro")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sctag_myers_micro(
            x.data_ptr(), x.numel(), iters, chains, grid, out.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(f"sctag_myers_micro launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
