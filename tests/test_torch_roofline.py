"""The int32 microkernel's plain version (sctagger_tpu_torch.ops.micro_cuda
.micro_ref) against the Pallas body it ports (tools/roofline.py
_micro_kernel, interpret mode on the CPU), the op-count formula, the SASS
loop counter of the port's roofline tool, and the measurement tools'
refusal to run without a card.

Tolerance: exact equality (int32 outputs)."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sctagger_tpu_torch.ops import micro_cuda as mic
from sctagger_tpu_torch.tools import profile_match, roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]
BP, BR = 8, 128
ITERS, GRID = 6, 2


def _jax_roofline():
    spec = importlib.util.spec_from_file_location("jax_roofline", ROOT / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("chains", mic.CHAINS)
def test_micro_ref_vs_pallas(chains):
    jr = _jax_roofline()
    x = mic.micro_input(BP, BR)
    want = pl.pallas_call(
        functools.partial(jr._micro_kernel, iters=ITERS, chains=chains),
        grid=(GRID,),
        in_specs=[pl.BlockSpec((BP, BR), lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((BP, BR), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((BP, BR), jnp.int32),
        interpret=True,
    )(jnp.asarray(x.numpy()))
    got = mic.micro(x, ITERS, chains, GRID)  # CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_micro_input_and_op_count():
    """The JAX tool's block and op count: grid * iters * chains * 21 * n."""
    jr = _jax_roofline()
    x = mic.micro_input(4, 16)
    np.testing.assert_array_equal(x.numpy(), np.arange(64, dtype=np.int32).reshape(4, 16))
    assert mic.OPS_PER_ITER == jr.MICRO_OPS_PER_ITER == 21
    assert mic.micro_ops(256 * 1024, 2048, 1, 64) == 64 * 2048 * 1 * 21 * 256 * 1024
    # every chain count runs the same ops at the tool's shapes
    ops = {mic.micro_ops(max(8, 256 // c) * 1024, 7, c, 3) for c in mic.CHAINS}
    assert len(ops) == 1


def test_micro_refuses_other_devices():
    with pytest.raises(ValueError, match="no microkernel"):
        mic.micro(torch.empty((8, 128), dtype=torch.int32, device="meta"), 4, 1)


SASS = """
        Function : _ZN4anon11myers_microILi2EEEvPKiiiiPi
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;               /* 0x0000000000007919 */
        /*0020*/                   IADD3 R2, R0, 0x1, RZ ;          /* 0x0000000100027810 */
        /*0030*/                   LOP3.LUT R3, R2, R4, RZ, 0xfc, !PT ;
        /*0040*/                   NOP ;
        /*0050*/                   ISETP.GE.AND P0, PT, R2, R5, PT ;
        /*0060*/               @!P0 BRA 0x20 ;                      /* 0xfffffffc00008947 */
        /*0070*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0080*/                   LOP3.LUT R7, R6, R4, RZ, 0xfc, !PT ;
        /*0090*/               @!P1 BRA 0x70 ;
        /*00a0*/               @!P2 BRA 0x10 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0;
"""


def test_sass_innermost_loop():
    """Backward branches make loops; the largest loop holding no other loop
    counts, NOPs excluded (0x20..0x60: 4 instructions)."""
    funcs = roofline.parse_sass(SASS)
    assert list(funcs) == ["_ZN4anon11myers_microILi2EEEvPKiiiiPi"]
    instrs = funcs["_ZN4anon11myers_microILi2EEEvPKiiiiPi"]
    assert instrs[0] == (0, "LDC R1, c[0x0][0x28]")
    assert roofline.innermost_loop(instrs) == 4
    assert roofline.innermost_loop(instrs[:3]) is None


@pytest.mark.parametrize("tool", [roofline, profile_match], ids=["roofline", "profile_match"])
def test_tools_refuse_to_run_without_a_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert exc.value.code == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
