"""Stage stats, traces and progress for the port: StageStats copied from
sctagger_tpu/observability.py; stage_scope's SCTAG_PROFILE=<dir> trace is a
torch.profiler trace (CPU activity, and CUDA activity when torch sees a
card) exported into <dir> as a Chrome trace, where the JAX package takes a
jax.profiler trace."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict

from .utils import _NullBar


class StageStats:
    """Accumulates counters/timings for one stage run."""

    def __init__(self, stage: str):
        self.stage = stage
        self.counters: dict[str, float] = defaultdict(float)
        self.timers: dict[str, float] = defaultdict(float)
        self._t0 = time.perf_counter()

    def count(self, key: str, n: float = 1) -> None:
        self.counters[key] += n

    @contextlib.contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[key] += time.perf_counter() - t0

    def emit(self) -> None:
        record = {
            "stage": self.stage,
            "wall_s": round(time.perf_counter() - self._t0, 3),
            "counters": {k: v for k, v in sorted(self.counters.items())},
            "timers_s": {
                k: round(v, 3) for k, v in sorted(self.timers.items())
            },
        }
        dest = os.environ.get("SCTAG_STATS")
        if not dest:
            return
        line = json.dumps(record)
        if dest == "1":
            print(line, file=sys.stderr)
        else:
            with open(dest, "a") as f:
                f.write(line + "\n")


@contextlib.contextmanager
def stage_scope(stage: str):
    """Counters + timers around a stage body, emitted per SCTAG_STATS, and
    with SCTAG_PROFILE=<dir> a profiler trace of the body in <dir>."""
    stats = StageStats(stage)
    profile_dir = os.environ.get("SCTAG_PROFILE")
    if profile_dir:
        with _profiled(profile_dir, stage):
            yield stats
    else:
        yield stats
    stats.emit()


@contextlib.contextmanager
def _profiled(profile_dir: str, stage: str):
    """torch.profiler around the body; the trace goes to
    <profile_dir>/<stage>.<pid>.<ns>.pt.trace.json (path on stderr)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(
        profile_dir, f"{stage}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    )
    prof.export_chrome_trace(path)
    print(f"[sctagger_tpu_torch] profile trace: {path}", file=sys.stderr)


def progress_bar(total=None, desc: str = "", unit: str = "it"):
    """tqdm progress bar on stderr (sctagger_tpu.utils.progress_bar's
    surface): on with SCTAG_PROGRESS=1, off with =0, and by default only
    when stderr is a TTY. A stderr without ``isatty`` (a replaced stream)
    counts as no TTY. A no-op bar when off or tqdm is missing."""
    flag = os.environ.get("SCTAG_PROGRESS")
    isatty = getattr(sys.stderr, "isatty", None)
    if flag == "0" or (flag != "1" and not (callable(isatty) and isatty())):
        return _NullBar()
    try:
        from tqdm import tqdm
    except ImportError:
        return _NullBar()
    return tqdm(total=total, desc=desc, unit=unit, file=sys.stderr)
