"""The PyTorch port imports no jax: every module of sctagger_tpu_torch loads
in a fresh interpreter where importing jax raises."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

MODULES = [
    "sctagger_tpu_torch",
    "sctagger_tpu_torch.cli",
    "sctagger_tpu_torch.runtime",
    "sctagger_tpu_torch.observability",
    "sctagger_tpu_torch.ops.myers",
    "sctagger_tpu_torch.ops.match_cuda",
    "sctagger_tpu_torch.ops._build",
    "sctagger_tpu_torch.ops.exact_prefilter",
    "sctagger_tpu_torch.ops.adapter_cuda",
    "sctagger_tpu_torch.models.matcher",
    "sctagger_tpu_torch.models.adapter",
    "sctagger_tpu_torch.stages.match_trie",
    "sctagger_tpu_torch.stages.extract_lr_bc",
    "sctagger_tpu_torch.ops.micro_cuda",
    "sctagger_tpu_torch.entry",
    "sctagger_tpu_torch.tools",
    "sctagger_tpu_torch.tools.profile_match",
    "sctagger_tpu_torch.tools.roofline",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_non_ported_subcommand_exits_nonzero(capsys):
    import pytest

    from sctagger_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main(["extract_sr_bc", "-i", "in.bam"])
    assert exc.value.code != 0
    assert "not yet ported to sctagger_tpu_torch" in capsys.readouterr().err
