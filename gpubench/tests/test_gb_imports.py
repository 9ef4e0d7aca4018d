"""Nothing the benchmark runs imports the JAX stack, the JAX package or the
old benchmark, by top-level name compared whole; the reference imports
nothing of the program either."""

import ast
import pathlib
import subprocess
import sys

import pytest

from gpubench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "sctagger_tpu", "bench", "flax", "tools"}


def imported(path):
    """Top-level names of the absolute imports in ``path``."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_no_old_benchmark(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "sctagger_tpu_torch" not in imported(path)
    assert "import_module" not in path.read_text()


def test_top_level_names_compared_whole():
    assert "sctagger_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "sctagger_tpu" in harness.FORBIDDEN


def test_a_run_loads_no_forbidden_module():
    """The harness and the port imported in a fresh process, as a run
    imports them, load no module of the JAX stack or package."""
    code = ("import sys; sys.path.insert(0, %r); import gpubench.harness as h, "
            "gpubench.stages.match_trie, gpubench.stages.extract_lr_bc, "
            "gpubench.stages.extract_sr_bc_from_lr, sctagger_tpu_torch.cli, "
            "sctagger_tpu_torch.stages.match_trie, sctagger_tpu_torch.stages.extract_lr_bc, "
            "sctagger_tpu_torch.stages.extract_sr_bc_from_lr; print(h.forbidden_modules())"
            % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip() == "[]"
