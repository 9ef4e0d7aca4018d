"""`extract_lr_bc` end to end: sctagger_tpu_torch.cli.main against
sctagger_tpu.cli.main on the same FASTQ fixtures (CPU).

The output TSVs must be identical after gunzip. Fixtures hold reads with
planted (mutated) adapters on both strands, reads without one, and reads
with in-sequence N (the kernel cannot take those: mask fallback)."""

import gzip

import numpy as np
import pytest
import torch

from sctagger_tpu.cli import main as jax_main
from sctagger_tpu.core.packing import rev_compl
from sctagger_tpu_torch.cli import main as torch_main

torch.set_num_threads(1)

ADAPTER = "CTACACGACGCTCTTCCGATCT"
ADAPTER_45 = ADAPTER + "AGTCAGGTACTTGCAGGCTAGGCTG"


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


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


def _fastq(path, rng, n_reads=150, adapter=ADAPTER, gz=False):
    lines = []
    for i in range(n_reads):
        seq = _dna(rng, int(rng.integers(60, 280)))
        r = rng.random()
        if r < 0.45:  # forward adapter near the start
            pos = int(rng.integers(5, 30))
            seq = seq[:pos] + _mutate(rng, adapter, int(rng.integers(0, 4))) + seq[pos:]
        elif r < 0.85:  # reverse-complement adapter near the end
            cut = max(0, len(seq) - int(rng.integers(5, 30)))
            seq = seq[:cut] + _mutate(rng, rev_compl(adapter), int(rng.integers(0, 4))) + seq[cut:]
        if rng.random() < 0.1:
            p = int(rng.integers(len(seq)))
            seq = seq[:p] + "N" + seq[p + 1 :]
        lines.append(f"@read{i} extra stuff\n{seq}\n+\n{'I' * len(seq)}\n")
    data = "".join(lines)
    if gz:
        path.write_bytes(gzip.compress(data.encode()))
    else:
        path.write_text(data)
    return path


def _both(tmp_path, argv):
    """Run both CLIs with ``argv`` + -o; return the two decompressed TSVs."""
    outs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"{name}.tsv.gz"
        main(["extract_lr_bc", *argv, "-o", str(out)])
        outs.append(gzip.decompress(out.read_bytes()))
    return outs


@pytest.mark.parametrize(
    "extra", [[], ["-g", "f1:40", "r1:45"], ["--num-bp-after", "7"]],
    ids=["auto", "preset", "num-bp-after"],
)
def test_cli_matches_jax(tmp_path, extra):
    rng = np.random.default_rng(20 + len(extra))
    fq = _fastq(tmp_path / "reads.fastq", rng)
    want, got = _both(tmp_path, ["-r", str(fq), "-t", "1", *extra])
    assert got == want
    assert b"\t-1\tNA\t\n" in got and got.count(b"\n") == 150


def test_gz_input_and_two_files(tmp_path):
    rng = np.random.default_rng(33)
    fq1 = _fastq(tmp_path / "a.fastq.gz", rng, n_reads=60, gz=True)
    fq2 = _fastq(tmp_path / "b.fastq.gz", rng, n_reads=40, gz=True)
    want, got = _both(tmp_path, ["-r", str(fq1), str(fq2), "-z"])
    assert got == want and got.count(b"\n") == 100


def test_multiword_adapter(tmp_path):
    rng = np.random.default_rng(45)
    fq = _fastq(tmp_path / "reads.fastq", rng, n_reads=80, adapter=ADAPTER_45)
    want, got = _both(tmp_path, ["-r", str(fq), "-sa", ADAPTER_45])
    assert got == want


def test_one_shot_path_and_stdout(tmp_path, monkeypatch, capsys):
    """SCTAG_STREAM=0 (one-shot scan) and the uncompressed stdout writer."""
    rng = np.random.default_rng(8)
    fq = _fastq(tmp_path / "reads.fastq", rng, n_reads=90)
    monkeypatch.setenv("SCTAG_STREAM", "0")
    want, got = _both(tmp_path, ["-r", str(fq)])
    assert got == want
    capsys.readouterr()
    jax_main(["extract_lr_bc", "-r", str(fq)])
    want_out = capsys.readouterr().out
    torch_main(["extract_lr_bc", "-r", str(fq)])
    assert capsys.readouterr().out == want_out
    assert want_out.count("\n") == 91  # the echoed arguments + 90 rows


def test_plotfile(tmp_path):
    rng = np.random.default_rng(9)
    fq = _fastq(tmp_path / "reads.fastq", rng, n_reads=50)
    plot = tmp_path / "dist.png"
    torch_main(["extract_lr_bc", "-r", str(fq), "-o", str(tmp_path / "o.tsv.gz"),
                "-p", str(plot)])
    assert plot.stat().st_size > 0


def test_not_ported_options_raise(tmp_path, monkeypatch):
    fq = _fastq(tmp_path / "reads.fastq", np.random.default_rng(1), n_reads=5)
    argv = ["extract_lr_bc", "-r", str(fq), "-o", str(tmp_path / "o.tsv.gz")]
    with pytest.raises(NotImplementedError, match="n-hosts"):
        torch_main([*argv, "--n-hosts", "2"])
    monkeypatch.setenv("SCTAG_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    with pytest.raises(NotImplementedError, match="SCTAG_CHECKPOINT_DIR"):
        torch_main(argv)


class _StreamWithoutIsatty:
    """A replaced stderr that, like some loggers' streams, has no isatty."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        self.parts.append(s)
        return len(s)

    def flush(self):
        pass


def test_stderr_without_isatty(tmp_path, monkeypatch):
    """The stage's progress bar treats a stderr without isatty as no TTY
    instead of crashing."""
    from sctagger_tpu_torch.observability import progress_bar

    rng = np.random.default_rng(2)
    fq = _fastq(tmp_path / "reads.fastq", rng, n_reads=30)
    err = _StreamWithoutIsatty()
    monkeypatch.setattr("sys.stderr", err)
    monkeypatch.delenv("SCTAG_PROGRESS", raising=False)
    assert type(progress_bar()).__name__ == "_NullBar"
    out = tmp_path / "o.tsv.gz"
    torch_main(["extract_lr_bc", "-r", str(fq), "-o", str(out)])
    assert gzip.decompress(out.read_bytes()).count(b"\n") == 30
    assert any("Filtering alignments" in p for p in err.parts)
