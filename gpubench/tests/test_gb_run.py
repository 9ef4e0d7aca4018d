"""The command, run as a check runs it."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
ARGS = ["--workload", "sr25k.match.sub", "--seed", str(2**31 + 5), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, extra_env=None):
    return subprocess.run([sys.executable, "gpubench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", **(extra_env or {})})


def test_without_a_card_it_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_do_not_make_a_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    p = _run(ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"segments_per_s", "setup_s"}
