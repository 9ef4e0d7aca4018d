"""Entry points of the port (port of __graft_entry__.entry and
__graft_entry__.dryrun_multichip).

``entry()`` returns ``(fn, example_args)``: ``fn`` is one forward step of
the flagship matcher, the per-read min distance over all patterns
(``match_min``: the K4 kernel on a CUDA device, its plain version on the
CPU), and the arguments are a toy problem on ``device`` (default:
``runtime.default_device()``, the card unless ``SCTAG_DEVICE=cpu``):
64 random 24 bp segments padded to 32 positions against 32 random 16 bp
barcodes, made with numpy from seed 0 exactly as the JAX package's
``_toy_problem`` makes them. ``fn(*example_args)[0, :64]`` equals the JAX
``entry()`` output.

    python -m sctagger_tpu_torch.entry

prints that output.

``dryrun_multichip(n)`` runs the production stages end to end on an
n-device grid (parallel/mesh.py): extract_lr_bc on a synthetic FASTQ, then
match_trie and extract_sr_bc_from_lr (the grid probe at n devices) on its
output, through ``cli.main`` at 1 device and at n devices, with
model-parallel 1 and 2. It
asserts that the grid path engaged over all n devices (mesh.STATS) and
that every TSV is byte-identical to the one-device run; runs
shard_match_full, shard_match_full_mp and shard_match_min against their
one-device twins; and injects a mid-stage drop into a checkpointed
match_trie at n devices, after which only the missing batches are
recomputed and the output is byte-identical. The devices are
compute_devices(): the cards, or the one resolved device repeated by
SCTAG_VIRTUAL_DEVICES, which the dry run sets to n for itself when fewer
than n devices are visible and the variable is unset.

    python -m sctagger_tpu_torch.entry dryrun_multichip 4

runs it (``SCTAG_DEVICE=cpu`` for the CPU).
"""

from __future__ import annotations

import contextlib
import gzip
import os
import pathlib
import sys
import tempfile

import numpy as np
import torch

from .core.packing import LENIENT_TABLE, encode_seqs, rev_compl
from .ops.match_cuda import (
    DEF_BP,
    DEF_BR,
    match_full,
    match_min,
    prep_peq_cols,
    prep_segs_T,
)
from .ops.myers import build_peq_multi
from .runtime import resolve_device

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


def entry(device=None):
    """(fn, example_args): one forward step and its arguments on ``device``
    (runtime.resolve_device). ``fn(seg_T, peq_pm)`` returns (1, R_pad)
    int32."""
    dev = resolve_device(device)
    seg_codes, peq = _toy_problem()
    seg_T = prep_segs_T(seg_codes, ls=seg_codes.shape[1], br=READ_BLOCK)
    args = (torch.from_numpy(seg_T).to(dev), torch.from_numpy(prep_peq_cols(peq)).to(dev))

    def fn(seg, pq):
        return match_min(seg, pq, BL)

    return fn, args


ADAPTER = "CTACACGACGCTCTTCCGATCT"


def _write_fixture(tmp: pathlib.Path) -> tuple[str, str, str]:
    """Synthetic FASTQ with planted adapters + an SR barcode TSV + a
    whitelist (the JAX dry run's fixture, seed 99)."""
    rng = np.random.default_rng(99)
    alpha = list("ACGT")

    def dna(n):
        return "".join(rng.choice(alpha, size=n))

    def mut(s, k):
        s = list(s)
        for _ in range(k):
            p = int(rng.integers(len(s)))
            op = rng.random()
            if op < 0.34:
                s[p] = alpha[int(rng.integers(4))]
            elif op < 0.67:
                del s[p]
            else:
                s.insert(p, alpha[int(rng.integers(4))])
        return "".join(s)

    bcs = sorted({dna(16) for _ in range(40)})
    lines = []
    for i in range(300):
        bc = mut(bcs[int(rng.integers(len(bcs)))], int(rng.integers(0, 3)))
        body = dna(int(rng.integers(60, 220)))
        r = rng.random()
        if r < 0.45:
            pos = int(rng.integers(3, 20))
            seq = body[:pos] + mut(ADAPTER, int(rng.integers(0, 3))) + bc + body[pos:]
        elif r < 0.8:
            ins = rev_compl(ADAPTER + bc)
            cut = max(0, len(body) - int(rng.integers(3, 20)))
            seq = body[:cut] + ins + body[cut:]
        else:
            seq = body
        lines.append(f"@r{i} x\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp / "reads.fastq"
    fq.write_text("".join(lines))
    sr = tmp / "sr.tsv"
    sr.write_text("".join(f"{b}\t{1000 - j}\n" for j, b in enumerate(bcs)))
    wl = tmp / "wl.txt"
    wl.write_text("".join(b + "\n" for b in bcs))
    return str(fq), str(sr), str(wl)


@contextlib.contextmanager
def _env(**kv):
    """Set (a str) or unset (None) environment variables for the body, then
    restore them."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dryrun_multichip(n_devices: int) -> dict:
    """The multi-device dry run (module note). Returns its summary; raises
    AssertionError on any difference."""
    from .parallel import mesh as pmesh

    virtual = os.environ.get("SCTAG_VIRTUAL_DEVICES")
    if virtual is None and len(pmesh.compute_devices()) < n_devices:
        virtual = str(n_devices)
    with _env(SCTAG_VIRTUAL_DEVICES=virtual, SCTAG_MAX_DEVICES=None,
              SCTAG_MODEL_PARALLEL=None,
              SCTAG_CHECKPOINT_DIR=None, SCTAG_CHECKPOINT_BATCH=None):
        devs = pmesh.compute_devices()
        if len(devs) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devs)} (SCTAG_VIRTUAL_DEVICES="
                f"{virtual}); run with SCTAG_VIRTUAL_DEVICES={n_devices}"
            )
        with tempfile.TemporaryDirectory(prefix="sctag_dryrun_") as tmp:
            return _dryrun(n_devices, pathlib.Path(tmp))


def _dryrun(n_devices: int, tmp: pathlib.Path) -> dict:
    from .cli import main as cli_main
    from .parallel import mesh as pmesh
    from .stages import match_trie as mt_mod

    fq, sr, wl = _write_fixture(tmp)

    def run_pipeline_once(tag: str, max_devices: int, model_parallel: int):
        """extract_lr_bc -> (match_trie, extract_sr_bc_from_lr) through the
        CLI; at several devices the alt stage's probe is the grid probe."""
        pmesh.STATS.update(sharded_calls=0, devices=0)
        lr = str(tmp / f"lr_{tag}.tsv.gz")
        out = str(tmp / f"match_{tag}.tsv")
        alt = str(tmp / f"alt_{tag}.tsv.gz")
        with _env(SCTAG_MAX_DEVICES=str(max_devices),
                  SCTAG_MODEL_PARALLEL=str(model_parallel)):
            cli_main(["extract_lr_bc", "-r", fq, "-o", lr])
            cli_main(["match_trie", "-lr", lr, "-sr", sr, "-mr", "2", "-t", "1",
                      "-o", out])
            before_alt = pmesh.STATS["sharded_calls"]
            cli_main(["extract_sr_bc_from_lr", "-i", lr, "-wl", wl, "-o", alt])
        return (gzip.open(lr, "rb").read(), pathlib.Path(out).read_bytes(),
                gzip.open(alt, "rb").read(), dict(pmesh.STATS),
                pmesh.STATS["sharded_calls"] - before_alt)

    lr_1, out_1, alt_1, stats_1, _ = run_pipeline_once("1dev", 1, 1)
    assert stats_1["sharded_calls"] == 0, stats_1  # one device: no grid
    lr_n, out_n, alt_n, stats, alt_sharded = run_pipeline_once("ndev", n_devices, 1)
    assert stats["sharded_calls"] > 0, stats  # the grid path engaged
    assert alt_sharded > 0, stats  # ...including the alt stage's probe
    assert stats["devices"] == n_devices, (stats, n_devices)
    assert lr_n == lr_1, "stage-1 TSV differs between 1 and N devices"
    assert out_n == out_1, "match TSV differs between 1 and N devices"
    assert alt_n == alt_1, "alt-stage TSV differs between 1 and N devices"
    assert out_1.count(b"\n") > 50, out_1[:200]  # non-trivial output
    assert alt_1.count(b"\n") > 5, alt_1[:200]
    mp = 2 if n_devices % 2 == 0 else 1
    if mp == 2:
        lr_mp, out_mp, alt_mp, stats_mp, _ = run_pipeline_once("mp2", n_devices, 2)
        assert stats_mp["devices"] == n_devices, stats_mp
        assert lr_mp == lr_1, "stage-1 TSV differs under model_parallel=2"
        assert out_mp == out_1, "match TSV differs under model_parallel=2"
        assert alt_mp == alt_1, "alt TSV differs under model_parallel=2"

    # the grid call path itself: K1 on data slices, K1 on data x model
    # slices with the exact tie merge, K4 with the min merge, each == its
    # one-device twin on the same tensors
    dev = pmesh.compute_devices()[0]
    seg_codes, peq = _toy_problem(n_segs=n_devices * DEF_BR - 5, ls=32)
    seg_T = torch.from_numpy(prep_segs_T(seg_codes, ls=32, br=n_devices * DEF_BR))
    peq_pm = torch.from_numpy(prep_peq_cols(peq, bp=mp * DEF_BP))
    seg_d, peq_d = seg_T.to(dev), peq_pm.to(dev)
    want = match_full(seg_d, peq_d, BL)
    got = pmesh.shard_match_full(pmesh.make_mesh(n_devices), seg_T, peq_pm, BL)
    assert torch.equal(got.cpu(), want.cpu()), "shard_match_full != one device"
    if mp == 2:
        mesh_mp = pmesh.make_mesh(n_devices, model_parallel=2)
        got = pmesh.shard_match_full_mp(mesh_mp, seg_T, peq_pm, BL)
        assert torch.equal(got.cpu(), want.cpu()), "shard_match_full_mp != one device"
    got = pmesh.shard_match_min(pmesh.make_mesh(n_devices, model_parallel=mp),
                                seg_T, peq_pm, BL)
    assert torch.equal(got.cpu(), match_min(seg_d, peq_d, BL).cpu()), \
        "shard_match_min != one device"

    # failure injection: a device drop mid-stage on the grid; the batch
    # checkpoint re-runs ONLY the missing batches, same bytes
    lr_path = str(tmp / "lr_ndev.tsv.gz")
    n_rows = gzip.open(lr_path, "rb").read().count(b"\n")
    batch = 64
    n_batches = -(-n_rows // batch)
    assert n_batches >= 4, (n_rows, batch)
    out_f = str(tmp / "match_fail.tsv")
    argv = ["match_trie", "-lr", lr_path, "-sr", sr, "-mr", "2", "-t", "1",
            "-o", out_f]
    real = mt_mod.match_segments
    calls: list[int] = []
    recomputes: list[int] = []

    def dying(*a, **k):
        if len(calls) >= 2:
            raise KeyboardInterrupt("injected mid-stage device drop")
        calls.append(1)
        return real(*a, **k)

    def counting(*a, **k):
        recomputes.append(1)
        return real(*a, **k)

    with _env(SCTAG_CHECKPOINT_DIR=str(tmp / "ckpt"),
              SCTAG_CHECKPOINT_BATCH=str(batch), SCTAG_MAX_DEVICES=str(n_devices)):
        mt_mod.match_segments = dying
        try:
            cli_main(argv)
            raise AssertionError("injected failure did not fire")
        except KeyboardInterrupt:
            pass
        finally:
            mt_mod.match_segments = real
        parts = list((tmp / "ckpt").glob("match_trie-*/part*.tsv"))
        assert len(parts) == 2, parts  # completed batches survived the drop
        mt_mod.match_segments = counting
        try:
            cli_main(argv)
        finally:
            mt_mod.match_segments = real
    assert len(recomputes) == n_batches - 2, (len(recomputes), n_batches)
    assert pathlib.Path(out_f).read_bytes() == out_1, (
        "recovered output differs from the happy-path run"
    )
    summary = {"devices": n_devices, "model_parallel": mp,
               "sharded_calls": stats["sharded_calls"], "alt_sharded_calls": alt_sharded,
               "match_rows": out_1.count(b"\n"), "batches": n_batches,
               "recomputed": len(recomputes), "device": str(dev)}
    print(
        f"dryrun_multichip({n_devices}): OK on {dev} x {n_devices}: extract_lr_bc + "
        f"match_trie + extract_sr_bc_from_lr (device probe) byte-identical at 1 vs "
        f"{n_devices} devices (sharded_calls={stats['sharded_calls']}, alt "
        f"{alt_sharded}), data x model {n_devices // mp} x {mp} too; grid K1/K4 == "
        f"one device; mid-stage drop recovered with {len(recomputes)}/{n_batches} "
        f"batches recomputed, byte-identical",
        file=sys.stderr,
    )
    return summary


if __name__ == "__main__":
    if sys.argv[1:2] == ["dryrun_multichip"]:
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 4)
    else:
        fn, args = entry()
        print(fn(*args)[0, :64].tolist())
