"""Snakefile-equivalent pipeline runner (port of
sctagger_tpu/pipeline/runner.py, driving the port's stages).

Drives the same DAG as the reference workflow (Snakefile:13-134) from the
same config.yaml schema (same sample-sheet keys, including the reference's
'whiltlist' spelling), with file-based checkpoint/resume: a rule is skipped
when its outputs exist and are newer than all inputs — the reference's
stage-granular resume contract.

Artifacts per sample (identical paths to the reference):
  {outpath}/{sample}/{sample}.sr_bc.tsv.gz            (extract_sr_bc)
  {outpath}/{sample}/{sample}.lr_bc.tsv.gz            (extract_lr_bc)
  {outpath}/{sample}/{sample}.sr_bc_from_lr.tsv.gz    (extract_sr_bc_from_lr)
  {outpath}/{sample}/{sample}.lr_bc_matches.tsv.gz    (match_trie)
  {outpath}/{sample}/{sample}.lr_bc_from_lr_matches.tsv.gz

cellranger_count runs only if the `cellranger` binary exists (external tool,
Snakefile:25-58); otherwise a pre-existing BAM at the expected path is used.

``run_pipeline`` loads the YAML file (PyYAML, imported there only) and hands
the parsed dict to ``run_config``, which runs it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace


def _load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _needs_run(outputs: list[str], inputs: list[str]) -> bool:
    if not all(os.path.exists(o) for o in outputs):
        return True
    newest_in = max((os.path.getmtime(i) for i in inputs if os.path.exists(i)),
                    default=0.0)
    oldest_out = min(os.path.getmtime(o) for o in outputs)
    return newest_in > oldest_out


def _announce(rule: str, sample: str, skipped: bool) -> None:
    tag = "skip (up to date)" if skipped else "run"
    print(f"[pipeline] {rule}[{sample}]: {tag}", file=sys.stderr)


def run_pipeline(config_path: str, samples: list[str] | None = None,
                 threads: int = 32, from_lr_only: bool = False) -> None:
    """Run the workflow of the sample sheet at ``config_path`` (YAML)."""
    run_config(_load_config(config_path), samples=samples, threads=threads,
               from_lr_only=from_lr_only)


def run_config(cfg: dict, samples: list[str] | None = None, threads: int = 32,
               from_lr_only: bool = False) -> None:
    """Run the workflow of a parsed sample sheet. The device stages run on
    runtime.default_device(): the card unless SCTAG_DEVICE=cpu asks for the
    CPU; extract_sr_bc is host code."""
    from ..cli import parse_args
    from ..stages import (
        extract_lr_bc,
        extract_sr_bc,
        extract_sr_bc_from_lr,
        match_trie,
    )

    outpath = cfg["outpath"].rstrip("/")
    clrg_d = os.path.abspath(outpath) + "/cellranger-out"
    todo = samples or list(cfg["samples"].keys())

    for sample in todo:
        s = cfg["samples"][sample]
        sdir = f"{outpath}/{sample}"
        os.makedirs(sdir, exist_ok=True)
        bam = f"{clrg_d}/{sample}/{sample}/outs/possorted_genome_bam.bam"
        lr_tsv = f"{sdir}/{sample}.lr_bc.tsv.gz"
        sr_tsv = f"{sdir}/{sample}.sr_bc.tsv.gz"
        sr_from_lr_tsv = f"{sdir}/{sample}.sr_bc_from_lr.tsv.gz"
        matches = f"{sdir}/{sample}.lr_bc_matches.tsv.gz"
        matches_from_lr = f"{sdir}/{sample}.lr_bc_from_lr_matches.tsv.gz"

        # --- cellranger_count (external tool) ---------------------------
        if not from_lr_only:
            if _needs_run([bam], [s["sr"]["I1"], s["sr"]["R1"], s["sr"]["R2"]]):
                if shutil.which("cellranger"):
                    _announce("cellranger_count", sample, skipped=False)
                    ref = cfg["references"][s["ref"]]["cellranger_ref"]
                    outdir = f"{clrg_d}/{sample}"
                    shutil.rmtree(outdir, ignore_errors=True)
                    os.makedirs(outdir, exist_ok=True)
                    subprocess.run(
                        [
                            "cellranger", "count", f"--id={sample}",
                            "--chemistry=SC3Pv3",
                            f"--transcriptome={os.path.abspath(ref)}",
                            f"--fastq={os.path.abspath(s['sr']['dir'])}",
                            f"--sample={s['sr']['prefix']}",
                            "--localcores", str(threads),
                            "--localmem", "512",
                        ],
                        cwd=outdir,
                        check=True,
                    )
                elif not os.path.exists(bam):
                    raise FileNotFoundError(
                        f"cellranger not installed and BAM missing: {bam}"
                    )
            else:
                _announce("cellranger_count", sample, skipped=True)

            # --- extract_sr_bc -----------------------------------------
            if _needs_run([sr_tsv], [bam]):
                _announce("extract_sr_bc", sample, skipped=False)
                extract_sr_bc.run(SimpleNamespace(
                    input=bam, outfile=sr_tsv, plotfile=None, threads=threads,
                    thresh=0.005, step_size=1000, max_barcode_cnt=25_000,
                ))
            else:
                _announce("extract_sr_bc", sample, skipped=True)

        # --- extract_lr_bc ---------------------------------------------
        lr_fastqs = list(s["lr_fastqs"])
        if _needs_run([lr_tsv], lr_fastqs):
            _announce("extract_lr_bc", sample, skipped=False)
            args = parse_args(
                ["extract_lr_bc", "-r", *lr_fastqs, "-o", lr_tsv,
                 "-t", str(threads)]
            )
            extract_lr_bc.run(args)
        else:
            _announce("extract_lr_bc", sample, skipped=True)

        # --- extract_sr_bc_from_lr --------------------------------------
        wl = s["whiltlist"]  # reference config spelling (config.yaml:10)
        if _needs_run([sr_from_lr_tsv], [lr_tsv, wl]):
            _announce("extract_sr_bc_from_lr", sample, skipped=False)
            extract_sr_bc_from_lr.run(SimpleNamespace(
                input=lr_tsv, barcode_whitelist=wl, outfile=sr_from_lr_tsv,
                thresh=0.005, step_size=1000, max_barcode_cnt=25_000,
            ))
        else:
            _announce("extract_sr_bc_from_lr", sample, skipped=True)

        # --- match_trie (vs SR whitelist and vs LR-derived whitelist) ----
        jobs = [(matches_from_lr, sr_from_lr_tsv)]
        if not from_lr_only:
            jobs.append((matches, sr_tsv))
        for out, sr_in in jobs:
            if _needs_run([out], [lr_tsv, sr_in]):
                _announce("match_trie", sample, skipped=False)
                match_trie.run(SimpleNamespace(
                    long_read_segments=lr_tsv, short_read_barcodes=sr_in,
                    max_error=2, mem=16.0, barcode_length=16,
                    threads=threads, plotfile=None, outfile=out,
                ))
            else:
                _announce("match_trie", sample, skipped=True)
