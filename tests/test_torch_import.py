"""The PyTorch port stands alone: every module of sctagger_tpu_torch loads
in a fresh interpreter where importing jax or sctagger_tpu raises, and no
file of the port (nor chip_smoke.py) names the JAX package in an import."""

import ast
import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest

import sctagger_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

MODULES = ["sctagger_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(sctagger_tpu_torch.__path__, "sctagger_tpu_torch.")
)


def test_module_list_holds_the_copies():
    for name in ("core.packing", "core.ranges", "io.fastq", "io.tsv", "native.build",
                 "utils", "plots", "cli", "observability", "ops.adapter_cuda",
                 "stages.extract_lr_bc", "tools.roofline", "core.cutoff", "io.bam",
                 "ops.exact_lookup", "ops.topk_count", "pipeline.checkpoint",
                 "pipeline.runner", "stages.extract_sr_bc",
                 "stages.extract_sr_bc_from_lr", "io.sharding", "parallel",
                 "parallel.mesh", "parallel.multihost", "entry"):
        assert f"sctagger_tpu_torch.{name}" in MODULES


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "sys.modules['sctagger_tpu'] = None\n"  # and so does the JAX package
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.split('.')[0] in ('jax', 'sctagger_tpu') for m in sys.modules"
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


def _imported_modules(text: str, pkg: tuple[str, ...]):
    """Every module name an import statement of ``text`` names; relative
    imports resolve against the package ``pkg`` of the file."""
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg[: len(pkg) - node.level + 1]
                base = ".".join([*parts, base] if base else parts)
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def _jax_imports(path: pathlib.Path) -> list[str]:
    pkg = path.relative_to(ROOT).parent.parts
    return [m for m in _imported_modules(path.read_text(), pkg)
            if m.split(".")[0] in ("sctagger_tpu", "jax")]


PORT_FILES = sorted((ROOT / "sctagger_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_the_jax_package(path):
    bad = _jax_imports(path)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("src,pkg,want", [
    ("from sctagger_tpu.core import packing\n", (), ["sctagger_tpu.core"]),
    ("import sctagger_tpu.io.tsv as t\n", (), ["sctagger_tpu.io.tsv"]),
    ("def f():\n    import jax\n", (), ["jax"]),
    ("from ..core.packing import encode_str\n", ("sctagger_tpu", "ops"),
     ["sctagger_tpu.core.packing"]),
    ("from ..core.packing import encode_str\n", ("sctagger_tpu_torch", "ops"), []),
])
def test_import_scan_catches_the_jax_package(src, pkg, want):
    """The scan itself: absolute, nested and relative imports resolve to the
    package they name."""
    got = sorted({m for m in _imported_modules(src, pkg)
                  if m.split(".")[0] in ("sctagger_tpu", "jax")})
    assert [g for g in got if g in want] == want and len(got) >= len(want)
    assert bool(got) == bool(want)


def test_non_ported_subcommand_exits_nonzero(tmp_path, monkeypatch):
    """Every subcommand is ported, --n-hosts > 1 included: with missing
    inputs each of the four raises FileNotFoundError (the reference's
    surface), as the JAX CLI does, and none NotImplementedError."""
    from sctagger_tpu.cli import main as jax_main
    from sctagger_tpu_torch.cli import main

    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "o.tsv.gz")
    for argv in (["extract_lr_bc", "-r", "a.fq"], ["extract_sr_bc", "-i", "in.bam"],
                 ["extract_sr_bc_from_lr", "-i", "lr.tsv", "-wl", "wl.txt"],
                 ["match_trie", "-lr", "lr.tsv", "-sr", "sr.tsv"]):
        for m in (main, jax_main):
            with pytest.raises(FileNotFoundError):
                m([*argv, "-o", out, "--n-hosts", "2"])
