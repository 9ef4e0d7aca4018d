"""`extract_sr_bc_from_lr` end to end: sctagger_tpu_torch.cli.main against
sctagger_tpu.cli.main on the same LR TSVs and whitelists (CPU), under the
host probe (one CPU device) and under the device probe (a grid of two CPU
devices: the probe follows the device).

The gz TSVs must be identical after gunzip. Whitelists cover a gz file with
a trailing newline, in one member and in two, a plain file with one and
without one (the reference's `l[:-1]` drops its last char), an empty file,
and files that the one-buffer read (io/whitelist.py) hands back to the line
read: \r\n and lone \r endings, a blank last line, and words with N or in
lowercase (the host dict fallback)."""

import gzip

import numpy as np
import pytest
import torch

from sctagger_tpu.cli import main as jax_main
from sctagger_tpu.core.packing import rev_compl
from sctagger_tpu_torch.cli import main as torch_main

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    """The stage runs on the card unless asked: ask for the CPU."""
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


# whitelist files: gz, or plain when PLAIN names them; the line ending and
# the words' length and case by kind
PLAIN = ("no_trailing_newline", "empty", "plain_uniform")
ENDING = {"crlf": "\r\n", "lone_cr": "\r"}


def _inputs(tmp_path, rng, wl_kind: str, n_wl=120, n_rows=600):
    k = 15 if wl_kind == "crlf" else 16  # 15 + \r: a 16-byte word the table refuses
    wl = sorted({_dna(rng, k) for _ in range(n_wl)})
    if wl_kind == "with_n":
        wl[3] = wl[3][:5] + "N" + wl[3][6:]
    if wl_kind == "lowercase":
        wl = [b.lower() for b in wl]
    text = "".join(b + ENDING.get(wl_kind, "\n") for b in wl)
    if wl_kind == "blank_last_line":
        text += "\n"
    if wl_kind not in PLAIN:
        wl_path = tmp_path / "wl.txt.gz"
        if wl_kind == "multi_member_gz":  # members split mid-line
            cut = len(text) // 3
            wl_path.write_bytes(gzip.compress(text[:cut].encode())
                                + gzip.compress(text[cut:].encode()))
        else:
            wl_path.write_bytes(gzip.compress(text.encode()))
    else:
        wl_path = tmp_path / "wl.txt"
        wl_path.write_bytes(b"" if wl_kind == "empty" else
                            text.encode()[:-1] if wl_kind == "no_trailing_newline"
                            else text.encode())
    weights = 1.0 / (np.arange(len(wl)) + 1.0) ** 1.1
    weights /= weights.sum()
    rows = []
    for i in range(n_rows):
        if rng.random() < 0.1:  # NA rows are skipped by the stage
            rows.append(f"read{i}\t-1\tNA\t\n")
            continue
        seg = _dna(rng, int(rng.integers(10, 45)))
        r = rng.random()
        if r < 0.7:
            bc = wl[int(rng.choice(len(wl), p=weights))]
            bc = rev_compl(bc) if rng.random() < 0.5 else bc
            p = int(rng.integers(0, len(seg)))
            seg = seg[:p] + bc + seg[p:]
        elif r < 0.8:  # two hits: ambiguous, dropped
            seg = seg[:2] + wl[int(rng.integers(len(wl)))] + seg[2:5] + wl[0] + seg[5:]
        if rng.random() < 0.05:
            p = int(rng.integers(len(seg)))
            seg = seg[:p] + "N" + seg[p + 1:]
        rows.append(f"read{i}\t1\t5\t{seg}\n")
    lr = tmp_path / "lr.tsv.gz"
    lr.write_bytes(gzip.compress("".join(rows).encode()))
    return wl_path, lr


def _both(tmp_path, argv):
    outs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"{name}.tsv.gz"
        main(["extract_sr_bc_from_lr", *argv, "-o", str(out)])
        outs.append(gzip.decompress(out.read_bytes()))
    return outs


@pytest.mark.parametrize("probe", ["host", "device"])
@pytest.mark.parametrize("wl_kind", [
    "gz", "no_trailing_newline", "empty", "with_n", "crlf", "lone_cr",
    "blank_last_line", "multi_member_gz", "lowercase", "plain_uniform",
])
def test_cli_matches_jax(tmp_path, monkeypatch, probe, wl_kind):
    rng = np.random.default_rng(len(wl_kind))
    wl, lr = _inputs(tmp_path, rng, wl_kind)
    if probe == "device":
        monkeypatch.setenv("SCTAG_VIRTUAL_DEVICES", "2")
    want, got = _both(tmp_path, ["-i", str(lr), "-wl", str(wl), "--step-size", "20"])
    assert got == want
    if wl_kind in ("empty", "blank_last_line"):
        # the blank line's empty word hits at every position: all ambiguous
        assert got == b""
    else:
        assert got.count(b"\n") > 10


@pytest.mark.parametrize("extra", [
    ["--max-barcode-cnt", "9"], ["--thresh", "0.1", "--step-size", "3"],
], ids=["cap9", "thresh-step3"])
def test_cutoff_options(tmp_path, monkeypatch, extra):
    rng = np.random.default_rng(40 + len(extra))
    wl, lr = _inputs(tmp_path, rng, "gz")
    monkeypatch.setenv("SCTAG_VIRTUAL_DEVICES", "2")  # the device probe
    want, got = _both(tmp_path, ["-i", str(lr), "-wl", str(wl), *extra])
    assert got == want and got


def test_stdout_and_n_hosts(tmp_path, capsys, monkeypatch):
    """Rows to stdout as the JAX CLI writes them; without a card the stage
    asks for SCTAG_DEVICE=cpu; with --n-hosts 2, host 0 alone probes its
    shard, then waits for host 1 at the first cross-host gather and gives
    up after SCTAG_SYNC_TIMEOUT, writing no output."""
    rng = np.random.default_rng(8)
    wl, lr = _inputs(tmp_path, rng, "gz", n_rows=200)
    argv = ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(wl)]
    if not torch.cuda.is_available():  # the device is resolved before any read
        monkeypatch.delenv("SCTAG_DEVICE")
        with pytest.raises(RuntimeError, match="SCTAG_DEVICE=cpu"):
            torch_main(argv)
        monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    capsys.readouterr()
    jax_main(argv)
    want = capsys.readouterr().out
    torch_main(argv)
    got = capsys.readouterr().out
    assert got.split("\n", 1)[1] == want.split("\n", 1)[1]
    monkeypatch.setenv("SCTAG_SYNC_TIMEOUT", "0.2")
    with pytest.raises(TimeoutError, match="red00001sum.h1"):
        torch_main([*argv, "-o", str(tmp_path / "o.tsv.gz"), "--n-hosts", "2"])
    assert not (tmp_path / "o.tsv.gz").exists()
