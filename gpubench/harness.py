"""One run of one cell: set-up, the measured window, the check, the line.

Set-up (``setup_s``, from the process's start): torch, the cell's inputs
made from the seed and written as the files a user hands the stage, and one
warm-up invocation on a slice of them, which loads (or on a checkout's
first run builds) the program's kernels and host library. The window is a
closed loop: the stage runs as a user runs it,
``sctagger_tpu_torch.cli.main([...])``, files in and files out, invocation
after invocation while time remains. After it, the check compares the
outputs with the plain reference (gpubench.reference), and the metrics are
read.

With ``trace`` the program's SCTAG_STATS records go to a file and
torch.profiler (CPU and CUDA) traces the window; the per-layer metrics are
read from both."""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import types

from . import manifest, trace as trace_mod

FORBIDDEN = {"jax", "jaxlib", "flax", "sctagger_tpu", "bench"}


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's, the JAX
    package's or the old benchmark's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


@contextlib.contextmanager
def _traced(on: bool, dev, workdir, stats_path, summary: dict, phases: dict):
    """With ``on``: the program's SCTAG_STATS records to ``stats_path`` and
    torch.profiler (CPU, and CUDA on the card) around the body; the trace's
    reduction (trace.summarize) lands in ``summary``."""
    if not on:
        yield
        return
    import torch

    os.environ["SCTAG_STATS"] = str(stats_path)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    t = time.perf_counter()
    os.environ.pop("SCTAG_STATS", None)
    path = workdir / "trace.json"
    prof.export_chrome_trace(str(path))
    del prof
    summary.update(trace_mod.summarize(path))
    phases["trace_bytes"] = path.stat().st_size
    path.unlink()
    phases["trace_s"] = time.perf_counter() - t


def _window(seconds: float, invoke, sync, workdir, stage_name: str):
    """The closed loop: invocations while time remains, each writing its own
    output, with the garbage of each collected before the next starts, as a
    user's next process would start clean. Returns (outputs, failed
    invocations, window seconds, seconds of each invocation): the window
    ends with the last invocation; a failed one ends it."""
    import torch

    outputs, failed, each = [], 0, []
    w0 = end = time.perf_counter()
    with torch.profiler.record_function(trace_mod.WINDOW):
        while time.perf_counter() - w0 < seconds:
            out = workdir / f"out.{len(outputs)}.tsv.gz"
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(f"gpubench.{stage_name}"):
                    invoke(out)
                sync()
            except Exception:
                traceback.print_exc()
                failed += 1
                end = time.perf_counter()
                break
            end = time.perf_counter()
            each.append(end - t)
            outputs.append(out)
            gc.collect()
    return outputs, failed, end - w0, each


def _libraries(root: pathlib.Path) -> dict:
    """Every library file under the checkout's build directory, by path, with
    its modification time (what a run finds built, and what it builds)."""
    return {str(f): f.stat().st_mtime for f in root.rglob("*.so")} if root.is_dir() else {}


def _power_limit() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str | None = None, overrides: dict | None = None) -> dict:
    """Run the cell; returns the result line as a dict (with ``checks``).
    ``device`` None asks for the card and raises NoDevice without enough
    of them; tests pass "cpu" with small ``overrides`` of the workload's
    ``params`` and the configuration."""
    import torch

    phases = {"imports_s": time.perf_counter() - t0}
    spec = manifest.cell(name)
    work = spec["workload"]
    params = {**work["params"], **(overrides or {}).get("params", {})}
    config = {**spec["config_data"], **(overrides or {}).get("config", {})}
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
            raise NoDevice(f"{name} needs {spec['chips']} CUDA device(s); torch sees "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
        torch.zeros(1, device=device)
    dev = torch.device(device)
    phases["device_init_s"] = time.perf_counter() - t0 - phases["imports_s"]
    os.environ.update({"SCTAG_DEVICE": dev.type, "SCTAG_PROGRESS": "0",
                       **work.get("env", {})})
    for var in ("SCTAG_STATS", "SCTAG_CHECKPOINT_DIR", "SCTAG_PROFILE"):
        os.environ.pop(var, None)
    stage = manifest.module("stages", work["stage"])
    gen = manifest.module("traffic", work["generator"])

    workdir = pathlib.Path(tempfile.mkdtemp(prefix="gpubench-"))
    try:
        t = time.perf_counter()
        data = gen.generate(params, config, seed)
        phases["generate_s"] = time.perf_counter() - t
        t = time.perf_counter()
        files = stage.write_inputs(data, config, params, workdir)
        phases["write_inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from sctagger_tpu_torch import cli

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        build_root = pathlib.Path(__file__).resolve().parents[1] / "build"
        found = _libraries(build_root)
        wall = time.time()
        cli.main(stage.argv(files, config, workdir / "warm.out.gz", warm=True))
        sync()
        gc.collect()
        gc.freeze()  # set-up's objects are not walked again by the window's collections
        setup_s = time.perf_counter() - t0
        phases["warm_up_s"] = time.perf_counter() - t
        new = {f: m for f, m in _libraries(build_root).items() if found.get(f) != m}
        phases["built"] = sorted(pathlib.Path(f).name for f in new)
        # the warm-up's seconds until its last library was written
        phases["build_s"] = max(new.values()) - wall if new else 0.0

        stats_path = workdir / "stats.jsonl"
        prof_summary = {}
        with _traced(trace, dev, workdir, stats_path, prof_summary, phases):
            outputs, failed, window_s, each = _window(
                seconds, lambda out: cli.main(stage.argv(files, config, out, warm=False)),
                sync, workdir, work["stage"])
        phases["invocation_s"] = each
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t = time.perf_counter()
        verdict, info = stage.check(data, config, params, outputs, dev, seed)
        phases["check_s"] = time.perf_counter() - t
        stats = []
        if stats_path.exists():
            stats = [json.loads(ln) for ln in stats_path.read_text().splitlines() if ln]
        ctx = types.SimpleNamespace(
            unit=stage.UNIT, units=len(outputs) * stage.units(data),
            invocations=len(outputs), window_s=window_s, setup_s=setup_s,
            stats=stats, prof=prof_summary, summary=stage.summary(data, config),
            config=config)
        metrics = {}
        for m in manifest.metrics(name, trace):
            v = manifest.module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        phases["written_bytes"] = sum(f.stat().st_size for f in workdir.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    attempted = len(outputs) + failed
    correct = (failed == 0 and attempted > 0
               and all(c["value"] <= c["limit"] for c in verdict.values()))
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": spec["chips"] if dev.type == "cuda" else 1,
        "memory_peak_bytes": int(peak),
        "power_limit_w": _power_limit() if dev.type == "cuda" else None,
    }
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if prof_summary:
        device_info["busy_s"] = prof_summary["busy_s"]
        device_info["window_s"] = prof_summary["window_s"]
        result["breakdown"] = {"device_ops": prof_summary["device_ops"],
                               "idle_gaps": prof_summary["idle_gaps"]}
    result["check_info"] = {"invocations": len(outputs), **info, **phases}
    result["checks"] = verdict
    return result


def main(args, t0: float) -> int:
    real_stdout = sys.stdout
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    except NoDevice as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), file=real_stdout)
    real_stdout.flush()
    return 0
