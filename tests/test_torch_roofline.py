"""The int32 microkernel's plain version (sctagger_tpu_torch.ops.micro_cuda
.micro_ref) against the Pallas body it ports (tools/roofline.py
_micro_kernel, interpret mode on the CPU), the op-count formula, the SASS
loop counter of the port's roofline tool, the issue-rate bound, and the
measurement tools' refusal to run without a card.

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


HOT_SASS = """
        Function : _ZN4anon13adapter_slotsEPKhiiPKiNS_3PeqEiiPi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LOP3.LUT R3, R2, R4, RZ, 0xfc, !PT ;
        /*0020*/                   ISETP.GT.AND P0, PT, R2, R5, PT ;
        /*0030*/                   BSSY B2, 0x80 ;
        /*0040*/               @P0 BRA P1, 0x80 ;
        /*0050*/                   VIMNMX R5, R5, R2, PT ;
        /*0060*/               @P3 BRA 0x80 ;
        /*0070*/                   SEL R6, R7, R6, !P2 ;
        /*0080*/                   BSYNC B2 ;
        /*0090*/                   IADD3 R2, R2, 0x1, RZ ;
        /*00a0*/               @!P4 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_hot_path_skips_forward_branches():
    """K6's counts: the whole loop 0x10..0xa0 holds 10 instructions; its hot
    path, which takes the branch at 0x40 and skips 0x50..0x70 (the
    bookkeeping), holds 7."""
    instrs = roofline.parse_sass(HOT_SASS)["_ZN4anon13adapter_slotsEPKhiiPKiNS_3PeqEiiPi"]
    assert roofline.innermost_loop(instrs) == 10
    assert roofline.innermost_loop(instrs, hot=True) == 7


@pytest.mark.parametrize("name,per_cell,hot", [("match_full", 170 / 8, None),
                                               ("adapter_scan", 1214 / 32, 651 / 32),
                                               ("adapter_scan@131072", 1214 / 32, 651 / 32)])
def test_sass_rates_count_the_whole_loop(name, per_cell, hot):
    """``sass_per_cell`` is the whole innermost loop per cell, for every
    kernel; K6's hot path is a key of its own and moves no rate."""
    sass = {"match_full": 170, "adapter_scan": 1214, "adapter_scan_hot": 651,
            "micro_1": 18, "micro_8": 95}
    ceiling = {"by_chains": {1: {"ops_per_s": 21e12}, 8: {"ops_per_s": 42e12}}}
    kernels = {name: {"cells_per_s": 1e12}}
    roofline.add_sass_rates(ceiling, kernels, sass)
    assert ceiling["sass_per_s"] == pytest.approx(max(1e12 * 18, 2e12 * 95 / 8))
    k = kernels[name]
    assert k["sass_per_cell"] == pytest.approx(per_cell)
    assert k["sass_per_s"] == pytest.approx(1e12 * per_cell)
    assert k["sass_share_of_ceiling"] == pytest.approx(1e12 * per_cell / ceiling["sass_per_s"])
    assert k.get("sass_hot_per_cell") == (None if hot is None else pytest.approx(hot))


@pytest.mark.parametrize("tool,argv", [(roofline, []), (profile_match, [])],
                         ids=["roofline", "profile_match"])
def test_tools_refuse_to_run_without_a_card(tool, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit) as exc:
        tool.main(argv)
    assert exc.value.code == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


@pytest.mark.parametrize("sms,mhz,sass,want_ms", [
    (132, 1980, 33_454_080_000, 1.0),  # H100 SXM at its maximum clock: 33.45 T/s
    (132, 990, 33_454_080_000, 2.0),  # half the clock, twice the time
    (114, 1755, 114 * 128 * 1755e6 * 3e-3, 3.0),  # another part
    (132, 1980, 0, 0.0),
])
def test_issue_bound_follows_from_sass_and_clock(sms, mhz, sass, want_ms):
    """The issue rate: SMs x 4 schedulers x 32 lanes x the SM clock; the
    bound: the SASS count over it."""
    assert roofline.issue_rate(sms, mhz) == sms * 4 * 32 * mhz * 1e6
    assert roofline.issue_bound_ms(sass, sms, mhz) == pytest.approx(want_ms)


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W, 1980 MHz, 1980 MHz\n",
     {"gpu": "NVIDIA H100 80GB HBM3, 700.00 W", "sm_mhz": 1980, "max_sm_mhz": 1980}),
    ("NVIDIA H100 PCIe, 350.00 W, 345 MHz, 1755 MHz",
     {"gpu": "NVIDIA H100 PCIe, 350.00 W", "sm_mhz": 345, "max_sm_mhz": 1755}),
])
def test_parse_clocks(line, want):
    assert roofline.parse_clocks(line) == want


def test_sass_rates_give_issue_shares():
    """With an issue rate, K7 at each chain count, the best of them and
    each kernel get a share of it, counting the instructions the function
    needs; MASK's loop covers a 32-char word of one strand."""
    issue = roofline.issue_rate(132, 1980)
    sass = {"micro_1": 23, "micro_8": 95, "adapter_mask": 696}
    ceiling = {"by_chains": {1: {"ops_per_s": 29e12}, 8: {"ops_per_s": 40e12}}}
    kernels = {"adapter_mask": {"cells_per_s": 1e12, "ops_per_cell": 24.0}}
    roofline.add_sass_rates(ceiling, kernels, sass, issue)
    # chains 1: its loop (23) exceeds the 21 source ops, which count
    for c, need in ((1, 21), (8, 95 / 8)):
        v = ceiling["by_chains"][c]
        assert v["issue_share"] == pytest.approx(v["ops_per_s"] / 21 * need / issue)
    assert ceiling["issue_share"] == max(v["issue_share"]
                                         for v in ceiling["by_chains"].values())
    k = kernels["adapter_mask"]
    assert k["sass_per_cell"] == roofline.sass_per_cell(sass, "adapter_mask") == 696 / 32
    assert k["issue_per_cell"] == 696 / 32
    assert k["issue_share"] == pytest.approx(1e12 * 696 / 32 / issue)
    assert "sass_hot_per_cell" not in k  # MASK's loop has no branch


@pytest.mark.parametrize("name,ops,want", [
    ("adapter_scan", 28.0, 651 / 32),  # the hot path, not the whole loop (1214)
    ("adapter_scan", 16.0, 16.0),  # source ops fewer than the hot path
    ("adapter_mask", 24.0, 696 / 32),  # no hot path: the whole loop
    ("adapter_mask", 20.0, 20.0),
    ("match_full", 22.25, 170 / 8),
    ("match_ties", 22.25, None),  # not counted: no bound
])
def test_issue_per_cell_counts_what_the_function_needs(name, ops, want):
    """The fewer of the source ops and the compiled hot path per cell, so a
    branch the hot path skips or an instruction beyond the source's work
    raises no share."""
    sass = {"match_full": 170, "adapter_scan": 1214, "adapter_scan_hot": 651,
            "adapter_mask": 696}
    assert roofline.issue_per_cell(sass, name, ops) == (
        None if want is None else pytest.approx(want))


def test_mask_inputs_on_the_cpu():
    """measure_mask's reads: 1,000-3,000 bp plus the adapter, sorted by
    length, ~2% junk; rows of a multiple of 32 byte codes, junk coded >= 4."""
    reads = roofline.adapter_reads(40, seed=5)
    lens = [len(r) for r in reads]
    assert lens == sorted(lens) and 1022 <= min(lens) and max(lens) < 3022
    junk = roofline.add_junk(np.random.default_rng(0), reads)
    assert [len(r) for r in junk] == lens
    share = sum(r.count("N") for r in junk) / sum(lens)
    assert 0.015 < share < 0.025 and not any("N" in r for r in reads)
    codes, ln, peq, m = roofline.mask_rows(junk, torch.device("cpu"))
    assert codes.shape[1] % 32 == 0 and codes.shape[1] >= max(lens) > codes.shape[1] - 32
    assert ln.tolist() == lens and m == 22 and peq.shape == (2, 4)
    for r, row in zip(junk[:5], codes[:5].numpy()):
        assert np.array_equal(row[: len(r)] >= 4, np.frombuffer(r.encode(), np.uint8) == 78)


def test_every_kernel_has_a_sass_pattern():
    """K1-K5, both K6 entries and K7 at each chain count are counted."""
    names = set(roofline.SASS_KERNELS)
    assert {"match_full", "match_full_dynls", "match_min", "match_best", "match_ties",
            "adapter_scan", "adapter_mask"} <= names
    assert {f"micro_{c}" for c in mic.CHAINS} <= names
    assert all(n in roofline.CELLS_PER_TRIP for n in names if not n.startswith("micro_"))
