"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by name."""

import re

import pytest

from gpubench import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    assert len(manifest.ROOT.joinpath("BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_deployments_name_distinct_sources():
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(set(sources)) == len(sources)


def test_check_time_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["source"]) and _line(conf["why"])
    assert conf["file"].startswith("gpubench/configs/")
    data = manifest._json(manifest.ROOT / conf["file"])
    assert data["name"] == conf["name"]
    assert sorted(conf["reduced"]) == sorted(data["reduced"])
    assert all(NAME.match(k) and k in data for k in conf["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    spec = manifest.cell(cell)
    assert set(k for k in spec if k not in ("workload", "config_data")) == {
        "name", "config", "traffic", "chips", "why"}
    assert spec["chips"] == 1 and _line(spec["why"]) and NAME.match(spec["traffic"])
    assert spec["workload"]["why"] == spec["why"]
    assert spec["workload"]["chips"] == spec["chips"]
    stage = manifest.module("stages", spec["workload"]["stage"])
    for attr in ("UNIT", "write_inputs", "argv", "units", "summary", "check"):
        assert hasattr(stage, attr), attr
    assert callable(manifest.module("traffic", spec["workload"]["generator"]).generate)
    e2e = [m["name"] for m in manifest.metrics(cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics(cell, True)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        keys |= {"layer", "moves"}
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
        if "moves" in metric:
            moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
            assert cell in moved.get("workloads", CELLS)
    assert callable(manifest.module("metrics", metric["name"]).read)


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup


def test_one_layer_name_per_module():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    stems = {}
    for lay in layers:
        stems.setdefault(lay.split(" (")[0], set()).add(lay)
    assert all(len(v) == 1 for v in stems.values()), stems
