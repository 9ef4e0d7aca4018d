"""Batch checkpoint/resume (SCTAG_CHECKPOINT_DIR) in the port's four stages,
against sctagger_tpu on the same inputs (CPU).

For each stage: the checkpointed output equals the port's plain output,
which equals the JAX package's (exact bytes, gz decompressed); a resume
after deleting one part recomputes only that part and leaves the other
parts untouched; a changed batch size or input opens a new part store."""

import gzip
import os
import pathlib

import numpy as np
import pytest
import torch

from sctagger_tpu.cli import main as jax_main
from sctagger_tpu.core.packing import rev_compl
from sctagger_tpu_torch.cli import main as torch_main
from sctagger_tpu_torch.stages import (
    extract_lr_bc,
    extract_sr_bc,
    extract_sr_bc_from_lr,
    match_trie,
)

from bamgen import write_bam

torch.set_num_threads(1)

ADAPTER = "CTACACGACGCTCTTCCGATCT"


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    monkeypatch.delenv("SCTAG_CHECKPOINT_DIR", raising=False)


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _mutate(rng, s: str, k: int) -> str:
    b = list(s)
    for _ in range(k):
        b[int(rng.integers(len(b)))] = "ACGT"[int(rng.integers(4))]
    return "".join(b)


def _match_trie_inputs(tmp, rng):
    barcodes = sorted({_dna(rng, 16) for _ in range(30)})
    sr = tmp / "sr.tsv"
    sr.write_text("".join(f"{b}\t3\n" for b in barcodes))
    rows = []
    for i in range(60):
        seg = _dna(rng, 20)
        if rng.random() < 0.7:
            bc = _mutate(rng, barcodes[int(rng.integers(len(barcodes)))],
                         int(rng.integers(0, 3)))
            seg = seg[:4] + (rev_compl(bc) if rng.random() < 0.4 else bc) + seg[4:]
        rows.append(f"r{i}\t0\t3\t{seg}\n" if rng.random() > 0.05 else f"r{i}\t-1\tNA\t\n")
    lr = tmp / "lr.tsv"
    lr.write_text("".join(rows))
    return ["match_trie", "-lr", str(lr), "-sr", str(sr), "-t", "1"], lr


def _extract_lr_bc_inputs(tmp, rng):
    recs = []
    for i in range(40):
        t = _dna(rng, int(rng.integers(80, 160)))
        if rng.random() < 0.6:
            pos = int(rng.integers(0, 15))
            t = t[:pos] + _mutate(rng, ADAPTER, int(rng.integers(0, 2))) + t[pos:]
        if rng.random() < 0.1:
            t = t[:50] + "N" + t[51:]
        recs.append(f"@r{i}\n{t}\n+\n{'I' * len(t)}\n")
    fq = tmp / "r.fastq"
    fq.write_text("".join(recs))
    return ["extract_lr_bc", "-r", str(fq), "-t", "1"], fq


def _alt_inputs(tmp, rng):
    bcs = sorted({_dna(rng, 16) for _ in range(25)})
    wl = tmp / "wl.txt"
    wl.write_text("".join(b + "\n" for b in bcs))
    rows = []
    for i in range(60):
        seg = _dna(rng, 4) + bcs[int(rng.integers(len(bcs)))] + _dna(rng, 4)
        rows.append(f"r{i}\t1\t5\t{seg}\n")
    lr = tmp / "lr.tsv"
    lr.write_text("".join(rows))
    return ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl)], lr


def _bam_inputs(tmp, rng):
    pool = [_dna(rng, 16) for _ in range(40)]
    weights = 1.0 / (np.arange(40) + 1.0)
    weights /= weights.sum()
    contigs = ["chr1", "chr2"]
    alns = {c: [] for c in contigs}
    for i in range(4000):
        flag = int(rng.choice([0, 16, 256, 1024]))
        bc = pool[int(rng.choice(40, p=weights))]
        alns[contigs[i % 2]].append({
            "flag": flag, "name": f"q{i}", "pos": i,
            "tags": [["NM", 1], ["CB", bc + "-1"]], "seq": _dna(rng, 8),
        })
    path = tmp / "sr.bam"
    write_bam(str(path), contigs, alns)
    return ["extract_sr_bc", "-i", str(path), "-t", "1"], path


# stage: (inputs, module, function a batch calls, part store prefix, part ext)
STAGES = {
    "match_trie": (_match_trie_inputs, match_trie, "match_segments",
                   "match_trie", "tsv"),
    "extract_lr_bc": (_extract_lr_bc_inputs, extract_lr_bc, "scan_adapters_stream",
                      "extract_lr_bc_scan", "npz"),
    "extract_sr_bc_from_lr": (_alt_inputs, extract_sr_bc_from_lr, "probe_segments",
                              "extract_sr_bc_from_lr_scan", "npz"),
    "extract_sr_bc": (_bam_inputs, extract_sr_bc, "extract_cb_counts_range",
                      "extract_sr_bc", "npz"),
}


def _batch_env(monkeypatch, stage: str, inp: pathlib.Path, n: int = 4) -> None:
    """About ``n`` batches: rows for three stages, compressed bytes for the
    BAM scan."""
    if stage == "extract_sr_bc":
        monkeypatch.setenv("SCTAG_SR_BATCH_BYTES", str(os.path.getsize(inp) // n))
    else:
        monkeypatch.setenv("SCTAG_CHECKPOINT_BATCH", "16")


def _read(path: pathlib.Path) -> bytes:
    data = path.read_bytes()
    return gzip.decompress(data) if data[:2] == b"\x1f\x8b" else data


def _counting(monkeypatch, module, fn_name: str) -> list:
    calls = []
    real = getattr(module, fn_name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, fn_name, counted)
    return calls


def _out(tmp: pathlib.Path, stage: str, tag: str) -> pathlib.Path:
    return tmp / (f"{tag}.tsv" if stage == "match_trie" else f"{tag}.tsv.gz")


@pytest.mark.parametrize("stage", list(STAGES))
def test_checkpointed_equals_plain_equals_jax_and_resumes(tmp_path, monkeypatch, stage):
    make, module, fn_name, prefix, ext = STAGES[stage]
    argv, inp = make(tmp_path, np.random.default_rng(90 + len(stage)))
    jax_main([*argv, "-o", str(_out(tmp_path, stage, "jax"))])
    torch_main([*argv, "-o", str(_out(tmp_path, stage, "plain"))])
    want = _read(_out(tmp_path, stage, "jax"))
    assert _read(_out(tmp_path, stage, "plain")) == want and want

    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    _batch_env(monkeypatch, stage, inp)
    calls = _counting(monkeypatch, module, fn_name)
    torch_main([*argv, "-o", str(_out(tmp_path, stage, "c1"))])
    assert _read(_out(tmp_path, stage, "c1")) == want
    parts = sorted(ckpt.glob(f"{prefix}-*/part*.{ext}"))
    assert len(parts) == len(calls) >= 3

    # delete one part: only that batch recomputes, the others stay as they were
    gone = parts[1]
    gone.unlink()
    kept = {p: p.stat().st_mtime_ns for p in parts if p != gone}
    calls.clear()
    torch_main([*argv, "-o", str(_out(tmp_path, stage, "c2"))])
    assert _read(_out(tmp_path, stage, "c2")) == want
    assert len(calls) == 1 and gone.exists()
    assert {p: p.stat().st_mtime_ns for p in kept} == kept

    # fully cached: nothing recomputes
    calls.clear()
    torch_main([*argv, "-o", str(_out(tmp_path, stage, "c3"))])
    assert _read(_out(tmp_path, stage, "c3")) == want and not calls


@pytest.mark.parametrize("stage", list(STAGES))
def test_batch_size_or_input_change_opens_a_new_store(tmp_path, monkeypatch, stage):
    make, _, _, prefix, _ = STAGES[stage]
    argv, inp = make(tmp_path, np.random.default_rng(70 + len(stage)))
    ckpt = tmp_path / "ckpt"
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(ckpt))
    _batch_env(monkeypatch, stage, inp)
    torch_main([*argv, "-o", str(_out(tmp_path, stage, "a"))])
    want = _read(_out(tmp_path, stage, "a"))
    stores = {p.name for p in ckpt.glob(f"{prefix}-*")}
    assert len(stores) == 1

    _batch_env(monkeypatch, stage, inp, n=3)
    if stage != "extract_sr_bc":
        monkeypatch.setenv("SCTAG_CHECKPOINT_BATCH", "20")
    torch_main([*argv, "-o", str(_out(tmp_path, stage, "b"))])
    assert _read(_out(tmp_path, stage, "b")) == want
    after_batch = {p.name for p in ckpt.glob(f"{prefix}-*")}
    assert len(after_batch) == 2 and stores < after_batch

    st = inp.stat()
    os.utime(inp, (st.st_atime, st.st_mtime + 10))  # same bytes, newer input
    torch_main([*argv, "-o", str(_out(tmp_path, stage, "c"))])
    assert _read(_out(tmp_path, stage, "c")) == want
    assert len({p.name for p in ckpt.glob(f"{prefix}-*")}) == 3


def test_launch_counters_exact_under_threads(monkeypatch):
    """Two checkpointed match_trie batches launch from two threads: the
    launch counters lose no update, with more threads than cores and a short
    switch interval."""
    import sys
    import threading

    from sctagger_tpu_torch.ops import match_cuda as mc

    n_threads, per_thread = 4 * (os.cpu_count() or 1), 2000
    monkeypatch.setattr(mc, "LAUNCHES", 0)
    monkeypatch.setattr(mc, "BEST_LAUNCHES", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                mc._count("LAUNCHES")
                mc._count("BEST_LAUNCHES")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert mc.LAUNCHES == mc.BEST_LAUNCHES == n_threads * per_thread
