"""``extract_lr_bc -r <part1.fastq> ... -o <lr_bc.tsv.gz>``, stage 1 of both
routes (Snakefile rule extract_lr_bc).

Check: the whole output, row by row, against reference.lr; every
invocation's output equals the last one's."""

from __future__ import annotations

import numpy as np

from .. import seqs
from ..reference import lr as ref
from . import common

UNIT = "reads"
NUM_BP_AFTER = 20  # the stage's default --num-bp-after


def _write_fastq(path, data, rows) -> None:
    """Records ``@name / bases / + / qualities`` of ``rows``."""
    txt = seqs.codes_to_ascii(data["reads"][rows])
    w = txt.shape[1]
    bases = memoryview(txt.reshape(-1))
    names = memoryview(np.ascontiguousarray(data["names"][rows]).reshape(-1))
    qual = memoryview(data["qual"].tobytes())
    parts = []
    for i, n in enumerate(data["lens"][rows].tolist()):
        parts += (b"@", names[36 * i:36 * i + 36], b"\n", bases[i * w:i * w + n], b"\n+\n",
                  qual[:n], b"\n")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def write_inputs(data, config, params, workdir) -> dict:
    n = data["lens"].size
    parts = np.array_split(np.arange(n), data["parts"])
    files = []
    for i, rows in enumerate(parts):
        files.append(workdir / f"reads.{i}.fastq")
        _write_fastq(files[-1], data, rows)
    warm = []
    for i, rows in enumerate(parts):
        warm.append(workdir / f"reads.warm.{i}.fastq")
        _write_fastq(warm[-1], data, rows[: int(params["warm_reads"]) // len(parts)])
    return {"reads": files, "reads_warm": warm}


def argv(files, config, out, warm: bool) -> list[str]:
    reads = files["reads_warm" if warm else "reads"]
    return ["extract_lr_bc", "-r", *map(str, reads), "-o", str(out),
            "-sa", config["adapter"], "--num-bp-after", str(NUM_BP_AFTER)]


def units(data) -> int:
    return int(data["lens"].size)


def summary(data, config) -> dict:
    return {"mean_read_len": float(data["lens"].mean()),
            "adapter_len": len(config["adapter"])}


def check(data, config, params, outputs, device, seed, control=None):
    """(verdict, info). With ``control="band"`` the rows judged are the
    reference's with reads beyond distance 2 left without a strand (the
    host prefilter's tiers alone)."""
    expected = common.lines(ref.expected_tsv(data, config["adapter"], NUM_BP_AFTER, device))
    if control == "band":
        observed = common.lines(ref.expected_tsv(data, config["adapter"], NUM_BP_AFTER, device,
                                                 band=2))
        differ = 0
    elif control is None:
        text = common.read_text(outputs[-1]) if outputs else b""
        observed = common.lines(text)
        differ = common.outputs_differ(outputs, text) if outputs else 1
    else:
        raise ValueError(f"unknown control {control!r}")
    return common.verdict(rows_wrong=(common.rows_wrong(expected, observed), 0),
                          outputs_differ=(differ, 0)), {"rows": len(expected)}
