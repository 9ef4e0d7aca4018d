"""`extract_sr_bc` end to end: sctagger_tpu_torch.cli.main against
sctagger_tpu.cli.main on the same synthetic BAMs (tests/bamgen.py; CPU).

The gz TSVs must be identical after gunzip. The stage is host C++ in both
packages, so the port runs it without asking for a device."""

import gzip

import numpy as np
import pytest

from sctagger_tpu.cli import main as jax_main
from sctagger_tpu_torch.cli import main as torch_main

from bamgen import write_bam


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _bam(tmp_path, rng, n_alns=1500, kind="skewed"):
    """A BAM over three contigs. ``kind``: ``skewed`` (1/rank barcode
    frequencies; dropped flags, flag 256 kept, CB without -1, no CB, CB NA,
    B arrays), ``empty`` (no records), ``filtered`` (every flag > 256),
    ``flat`` (40 barcodes in 4 tiers of equal counts, so the elbow falls
    inside a run of equal counts)."""
    contigs = ["chr1", "chr2", "chr3"]
    alns = {c: [] for c in contigs}
    pool = [_dna(rng, 16) for _ in range(40)]
    if kind == "empty":
        n_alns = 0
    if kind == "flat":
        picks = np.repeat(np.arange(40), np.repeat([60, 30, 12, 3], 10))
        rng.shuffle(picks)
        n_alns = picks.size
    weights = 1.0 / (np.arange(40) + 1.0)
    weights /= weights.sum()
    for i in range(n_alns):
        c = contigs[int(rng.integers(3))]
        tags = [["NM", int(rng.integers(5))]]
        r = rng.random()
        if kind == "filtered":
            flag = int(rng.choice([272, 512, 1024, 2048]))
        elif kind == "flat":  # every record kept: the tiers stay tied
            flag = int(rng.choice([0, 16, 256]))
        elif r < 0.05:
            flag = int(rng.choice([272, 512, 1024, 2048]))  # dropped
        elif r < 0.1:
            flag = 256  # kept (the reference keeps flag == 256)
        else:
            flag = int(rng.choice([0, 16, 83, 99, 147, 163]))
        if kind == "flat":
            tags.append(["CB", pool[picks[i]] + "-1"])
        else:
            r2 = rng.random()
            if r2 < 0.04:
                pass  # no CB tag
            elif r2 < 0.07:
                tags.append(["CB", "NA"])  # counted in total, no barcode
            else:
                bc = pool[int(rng.choice(40, p=weights))]
                tags.append(["CB", bc + ("-1" if rng.random() < 0.85 else "")])
        if rng.random() < 0.05:
            tags.append(["XA", [1, 2, 3]])
        alns[c].append({"flag": flag, "name": f"q{i}", "pos": i % 1000,
                        "tags": tags, "seq": _dna(rng, int(rng.integers(0, 6)) * 2)})
    path = str(tmp_path / f"{kind}.bam")
    write_bam(path, contigs, alns)
    return path


def _both(tmp_path, argv):
    outs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"{name}.tsv.gz"
        main(["extract_sr_bc", *argv, "-o", str(out)])
        outs.append(gzip.decompress(out.read_bytes()))
    return outs


@pytest.mark.parametrize("kind,extra", [
    ("skewed", []),
    ("skewed", ["--step-size", "5"]),
    ("skewed", ["--step-size", "3", "--thresh", "0.02"]),
    ("skewed", ["--max-barcode-cnt", "7", "--step-size", "2"]),
    ("skewed", ["--thresh", "0"]),
    ("flat", ["--step-size", "13", "--thresh", "0.3"]),
    ("flat", ["--step-size", "10", "--thresh", "0.2"]),
    ("empty", []),
    ("filtered", []),
], ids=["default", "step5", "step3-thresh", "cap7", "thresh0", "flat-elbow13",
        "flat-elbow10", "empty", "filtered"])
def test_cli_matches_jax(tmp_path, kind, extra):
    rng = np.random.default_rng(len(kind) + len(extra))
    bam = _bam(tmp_path, rng, kind=kind)
    want, got = _both(tmp_path, ["-i", bam, "-t", "1", *extra])
    assert got == want
    if kind in ("empty", "filtered"):
        assert got == b""
    else:
        assert got.count(b"\n") > 0


def test_flat_counts_cut_inside_a_tie_run(tmp_path):
    """The elbow falls inside a run of equal counts, so which of the tied
    barcodes are written depends on the first-appearance order."""
    rng = np.random.default_rng(5)
    bam = _bam(tmp_path, rng, kind="flat")
    want, got = _both(tmp_path, ["-i", bam, "--step-size", "13", "--thresh", "0.3"])
    rows = [ln.split(b"\t") for ln in got.splitlines()]
    assert got == want and len(rows) == 26
    counts = [int(c) for _, c in rows]
    assert counts[20:] == [12] * 6  # 6 of the 10 barcodes seen 12 times


def test_stdout_plot_and_no_device_needed(tmp_path, capsys, monkeypatch):
    """Rows to stdout (after the argument echo and the stage's prints) as
    the JAX CLI writes them; -p writes the plot; no SCTAG_DEVICE needed."""
    monkeypatch.delenv("SCTAG_DEVICE", raising=False)
    rng = np.random.default_rng(9)
    bam = _bam(tmp_path, rng)
    jax_main(["extract_sr_bc", "-i", bam])
    want = capsys.readouterr().out
    plot = tmp_path / "cov.png"
    torch_main(["extract_sr_bc", "-i", bam, "-p", str(plot)])
    got = capsys.readouterr().out
    assert got.split("\n", 1)[1] == want.split("\n", 1)[1]
    assert plot.stat().st_size > 0


def test_missing_bam_and_n_hosts_raise(tmp_path):
    for main in (jax_main, torch_main):
        with pytest.raises(FileNotFoundError):
            main(["extract_sr_bc", "-i", str(tmp_path / "nope.bam"),
                  "-o", str(tmp_path / "o.tsv.gz")])
        # --n-hosts 2 is ported: the missing BAM raises the same way there
        with pytest.raises(FileNotFoundError):
            main(["extract_sr_bc", "-i", str(tmp_path / "x.bam"),
                  "-o", str(tmp_path / "o.tsv.gz"), "--n-hosts", "2"])
