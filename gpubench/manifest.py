"""Finding a cell's parts by name: BENCHMARK.json at the checkout's root,
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<generator>.py``, ``stages/<stage>.py``, ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell's BENCHMARK.json entry with its workload file and its
    configuration file merged in (``workload``, ``config_data``)."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    work = _json(HERE / "workloads" / f"{name}.json")
    if work["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config {work['config']!r}")
    return {**entry, "workload": work, "config_data": _json(ROOT / conf["file"])}


def metrics(name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    bench = benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def module(kind: str, name: str):
    """``gpubench.<kind>.<name>``; a name with dots loads from its file."""
    if "." not in name:
        return importlib.import_module(f"gpubench.{kind}.{name}")
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench.{kind}._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
