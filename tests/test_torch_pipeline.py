"""The port's pipeline runner against sctagger_tpu's on the same sample
sheet (CPU): every artifact byte-identical (gz decompressed), and a second
call skips every rule."""

import gzip
import os

import numpy as np
import pytest
import torch
import yaml

from sctagger_tpu.cli import main as jax_main
from sctagger_tpu.core.packing import rev_compl
from sctagger_tpu_torch.cli import main as torch_main
from sctagger_tpu_torch.pipeline.runner import run_config

from bamgen import write_bam

torch.set_num_threads(1)

ADAPTER = "CTACACGACGCTCTTCCGATCT"
ARTIFACTS = ["lr_bc", "sr_bc_from_lr", "lr_bc_from_lr_matches"]
ALL_ARTIFACTS = ARTIFACTS + ["sr_bc", "lr_bc_matches"]


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")


def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _sample(tmp, rng, n_reads=150, n_wl=200):
    """LR FASTQ (adapter + whitelist barcode, 40% reverse strand) and a gz
    whitelist, as tests/test_pipeline.py builds them."""
    wl = sorted({_dna(rng, 16) for _ in range(n_wl)})
    wl_path = tmp / "wl.txt.gz"
    wl_path.write_bytes(gzip.compress(("\n".join(wl) + "\n").encode()))
    recs = []
    for i in range(n_reads):
        a = list(ADAPTER)
        if rng.random() < 0.5:
            a[int(rng.integers(len(a)))] = "ACGT"[int(rng.integers(4))]
        seq = (_dna(rng, int(rng.integers(3, 10))) + "".join(a)
               + wl[int(rng.integers(len(wl)))] + _dna(rng, int(rng.integers(30, 80))))
        if rng.random() < 0.4:
            seq = rev_compl(seq)
        recs.append(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp / "lr.fastq"
    fq.write_text("".join(recs))
    return fq, wl_path, wl


def _config(tmp, out: str, fq, wl) -> dict:
    return {
        "outpath": str(tmp / out),
        "exec": {"scTagger": "unused"},
        "samples": {"s1": {
            "ref": "hs", "whiltlist": str(wl), "lr_fastqs": [str(fq)],
            "sr": {"I1": "x", "R1": "x", "R2": "x", "dir": ".", "prefix": "p",
                   "cell_count": 10},
        }},
        "references": {"hs": {"cellranger_ref": "unused"}},
    }


def _bam_at(path: str, rng, barcodes) -> None:
    """The BAM where cellranger would have written it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    alns = {"chr1": [{"flag": 0, "name": f"q{i}", "pos": i,
                      "tags": [["CB", barcodes[int(rng.integers(60))] + "-1"]]}
                     for i in range(900)]}
    write_bam(path, ["chr1"], alns)


def _artifacts(root, names):
    return {n: gzip.decompress((root / "s1" / f"s1.{n}.tsv.gz").read_bytes())
            for n in names}


def _run_both(tmp_path, cfgs, extra):
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfgs[name]))
        main(["pipeline", "-c", str(path), "-t", "1", *extra])
    return path


def test_from_lr_only_matches_jax_and_resumes(tmp_path, capsys):
    rng = np.random.default_rng(9)
    fq, wl, _ = _sample(tmp_path, rng)
    cfgs = {name: _config(tmp_path, f"out_{name}", fq, wl) for name in ("jax", "torch")}
    cfg_path = _run_both(tmp_path, cfgs, ["--from-lr-only"])
    got = _artifacts(tmp_path / "out_torch", ARTIFACTS)
    assert got == _artifacts(tmp_path / "out_jax", ARTIFACTS)
    assert got["lr_bc_from_lr_matches"].count(b"\n") > 50
    assert not (tmp_path / "out_torch" / "s1" / "s1.sr_bc.tsv.gz").exists()

    capsys.readouterr()
    root = tmp_path / "out_torch" / "s1"
    mtimes = {p: p.stat().st_mtime_ns for p in root.iterdir()}
    torch_main(["pipeline", "-c", str(cfg_path), "--from-lr-only", "-t", "1"])
    assert {p: p.stat().st_mtime_ns for p in root.iterdir()} == mtimes
    err = capsys.readouterr().err
    assert err.count("skip (up to date)") == 3 and "]: run" not in err


def test_whole_dag_with_an_existing_bam_matches_jax(tmp_path, capsys):
    """Without --from-lr-only: extract_sr_bc on the BAM at cellranger's path
    and match_trie against its whitelist too."""
    rng = np.random.default_rng(12)
    fq, wl, barcodes = _sample(tmp_path, rng)
    cfgs = {}
    for name in ("jax", "torch"):
        cfgs[name] = _config(tmp_path, f"out_{name}", fq, wl)
        bam = (f"{os.path.abspath(tmp_path / f'out_{name}')}/cellranger-out/s1/s1/"
               "outs/possorted_genome_bam.bam")
        _bam_at(bam, np.random.default_rng(3), barcodes)
    _run_both(tmp_path, cfgs, [])
    got = _artifacts(tmp_path / "out_torch", ALL_ARTIFACTS)
    assert got == _artifacts(tmp_path / "out_jax", ALL_ARTIFACTS)
    assert got["sr_bc"].count(b"\n") > 10 and got["lr_bc_matches"].count(b"\n") > 10
    capsys.readouterr()
    run_config(cfgs["torch"], threads=1)
    err = capsys.readouterr().err
    assert err.count("skip (up to date)") == 6 and "]: run" not in err  # + cellranger


def test_run_config_equals_the_yaml_run(tmp_path):
    """run_config (a parsed sample sheet; no YAML needed) writes what the
    CLI's YAML run writes."""
    rng = np.random.default_rng(21)
    fq, wl, _ = _sample(tmp_path, rng, n_reads=80)
    cfg = _config(tmp_path, "out_yaml", fq, wl)
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
    torch_main(["pipeline", "-c", str(tmp_path / "c.yaml"), "--from-lr-only", "-t", "1"])
    run_config(_config(tmp_path, "out_dict", fq, wl), threads=1, from_lr_only=True)
    assert _artifacts(tmp_path / "out_dict", ARTIFACTS) == \
        _artifacts(tmp_path / "out_yaml", ARTIFACTS)
