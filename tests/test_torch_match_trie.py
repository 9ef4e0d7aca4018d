"""`match_trie` end to end: sctagger_tpu_torch.cli.main against
sctagger_tpu.cli.main on the same TSV fixtures (CPU).

The output files must be byte-identical (decompressed for .gz), and the bad
paths must raise the same errors. Fixtures hold `-1 NA` rows with empty
segments, reverse-complement matches, and tie lists longer than 8."""

import gzip

import numpy as np
import pytest
import torch

from sctagger_tpu.cli import main as jax_main
from sctagger_tpu.core.packing import rev_compl
from sctagger_tpu_torch.cli import main as torch_main

torch.set_num_threads(1)


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


def _fixtures(tmp_path, bl: int, mr: int, seed: int):
    rng = np.random.default_rng(seed)
    core = _dna(rng, bl)
    bcs = [core] * 10 + [_dna(rng, bl) for _ in range(50)]  # 10 ties on core
    (tmp_path / "sr.tsv").write_text(
        "".join(f"{b}\t{int(rng.integers(1, 500))}\n" for b in bcs)
    )
    rows = []
    for i in range(120):
        kind = rng.random()
        if kind < 0.1:
            rows.append(f"read{i}\t-1\tNA\t\n")
            continue
        if kind < 0.3:
            b = core
        else:
            b = bcs[int(rng.integers(len(bcs)))]
        if rng.random() < 0.5:
            b = rev_compl(b)
        seg = _dna(rng, int(rng.integers(0, 8))) + _mutate(
            rng, b, int(rng.integers(0, mr + 2))
        ) + _dna(rng, int(rng.integers(0, 8)))
        if rng.random() < 0.05:
            seg = seg[:3] + "N" + seg[4:]
        rows.append(f"read{i}\t{int(rng.integers(0, 5))}\t7\t{seg}\n")
    (tmp_path / "lr.tsv").write_text("".join(rows))
    return tmp_path / "sr.tsv", tmp_path / "lr.tsv"


@pytest.mark.parametrize("bl,mr", [(12, 0), (16, 2), (20, 3), (40, 1)])
def test_match_trie_same_bytes(tmp_path, bl, mr):
    sr, lr = _fixtures(tmp_path, bl, mr, seed=bl + mr)
    args = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", str(mr),
            "-bl", str(bl), "-t", "1"]
    jax_main(args + ["-o", str(tmp_path / "jax.tsv")])
    torch_main(args + ["-o", str(tmp_path / "torch.tsv")])
    want = (tmp_path / "jax.tsv").read_bytes()
    assert (tmp_path / "torch.tsv").read_bytes() == want
    lines = want.decode().splitlines()
    assert any(int(ln.split("\t")[2]) > 8 for ln in lines)  # > 8 ties
    assert len(lines) < 120  # the -1 NA rows never match


def test_match_trie_gz_and_stdout(tmp_path, capsys):
    sr, lr = _fixtures(tmp_path, 16, 2, seed=3)
    lr_gz = tmp_path / "lr.tsv.gz"
    lr_gz.write_bytes(gzip.compress(lr.read_bytes()))
    args = ["match_trie", "-lr", str(lr_gz), "-sr", str(sr), "-t", "1"]
    jax_main(args + ["-o", str(tmp_path / "jax.tsv.gz")])
    torch_main(args + ["-o", str(tmp_path / "torch.tsv.gz")])
    want = gzip.decompress((tmp_path / "jax.tsv.gz").read_bytes())
    assert gzip.decompress((tmp_path / "torch.tsv.gz").read_bytes()) == want
    capsys.readouterr()
    torch_main(args)  # no -o: rows go to stdout after the argument echo
    out = capsys.readouterr().out
    assert out.split("\n", 1)[1].encode() == want


def test_match_trie_bad_paths(tmp_path):
    sr, lr = _fixtures(tmp_path, 16, 2, seed=4)
    missing = ["match_trie", "-lr", str(tmp_path / "nope.tsv"), "-sr", str(sr)]
    for main in (jax_main, torch_main):
        with pytest.raises(FileNotFoundError):
            main(missing)
        with pytest.raises(AssertionError):
            main(["match_trie", "-lr", str(lr), "-sr", str(sr),
                  "-mr", "16", "-bl", "16"])
