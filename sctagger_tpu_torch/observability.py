"""Stage stats, spans, traces and progress for the port.

``StageStats`` keeps one stage run's counters and timers and emits them as
one JSON record (SCTAG_STATS=1: stderr; SCTAG_STATS=<path>: appended), in
the record format of sctagger_tpu/observability.py.

A span times one phase. ``span(name)`` (from any thread) and
``StageStats.timer(name)`` add the phase's duration to ``timers[name]``;
``count(name, n)`` adds to ``counters[name]``. ``span`` and ``count`` write
to the stage that is running (``stage_scope``) and do nothing outside one.

With a sink on (SCTAG_STATS or SCTAG_PROFILE) the stage also records each
span: its name, start and end on the ``time.time_ns()`` clock (that of a
torch.profiler trace), its parent span, its thread (``main``: the stage's
own; else the worker thread's name) and the invocation id, which the record
carries as ``invocation`` beside the ``spans`` list. The stage itself is
the root span. While torch.profiler runs, a span on the stage's own thread
also opens the range ``sctag.<name>``; the profiler records no range opened
on another thread, so SCTAG_PROFILE=<dir> (a torch.profiler trace of the
stage: CPU, and CUDA when torch sees a card) adds the worker spans to the
trace file it writes, each on its own thread.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict

import torch

from .utils import _NullBar

_LOCK = threading.Lock()  # the running stage, and every stats dict
_running: "StageStats | None" = None
_invocations = itertools.count()
_open = threading.local()  # per thread: (stats, id) of the spans open on it
_NULL = contextlib.nullcontext()


class StageStats:
    """Accumulates counters/timings for one stage run."""

    def __init__(self, stage: str):
        self.stage = stage
        self.counters: dict[str, float] = defaultdict(float)
        self.timers: dict[str, float] = defaultdict(float)
        self._t0 = time.perf_counter()
        self._thread = threading.get_ident()
        self.invocation: str | None = None  # set when spans are recorded
        self.spans: list[dict] | None = None
        self._ids = itertools.count()
        self._root: int | None = None

    def count(self, key: str, n: float = 1) -> None:
        with _LOCK:
            self.counters[key] += n

    def timer(self, key: str) -> "_Span":
        return _Span(self, key)

    def merge(self, other: "StageStats") -> None:
        """Add ``other``'s counters and timers to this stage's."""
        with _LOCK:
            for k, v in other.counters.items():
                self.counters[k] += v
            for k, v in other.timers.items():
                self.timers[k] += v

    def emit(self) -> None:
        with _LOCK:
            record = {
                "stage": self.stage,
                "wall_s": round(time.perf_counter() - self._t0, 3),
                "counters": {k: v for k, v in sorted(self.counters.items())},
                "timers_s": {
                    k: round(v, 3) for k, v in sorted(self.timers.items())
                },
            }
            if self.spans is not None:
                record["invocation"] = self.invocation
                record["spans"] = sorted(self.spans, key=lambda s: s["start_ns"])
        dest = os.environ.get("SCTAG_STATS")
        if not dest:
            return
        line = json.dumps(record)
        if dest == "1":
            print(line, file=sys.stderr)
        else:
            with open(dest, "a") as f:
                f.write(line + "\n")

    def _begin(self) -> tuple[int, int | None, int]:
        """Open a span record on this thread: (id, parent id, start ns)."""
        sid = next(self._ids)
        stack = getattr(_open, "ids", None)
        if stack is None:
            stack = _open.ids = []
        parent = stack[-1][1] if stack and stack[-1][0] is self else self._root
        stack.append((self, sid))
        return sid, parent, time.time_ns()

    def _end(self, name: str, begun: tuple[int, int | None, int]) -> None:
        end = time.time_ns()
        _open.ids.pop()
        sid, parent, start = begun
        th = threading.current_thread()
        rec = {"name": name, "id": sid, "parent": parent,
               "thread": "main" if th.ident == self._thread else th.name,
               "tid": threading.get_native_id(), "start_ns": start,
               "end_ns": end, "invocation": self.invocation}
        with _LOCK:
            self.spans.append(rec)


class _Span:
    """One phase: its duration goes to ``stats.timers[name]`` (unless
    ``name`` is None: the stage's root span); recorded and given a profiler
    range as the module note says."""

    __slots__ = ("stats", "name", "_range", "_rec", "_begun", "_t0")

    def __init__(self, stats: StageStats, name: str | None):
        self.stats = stats
        self.name = name

    def __enter__(self):
        stage = _running or self.stats
        name = self.name or stage.stage
        self._range = None
        if threading.get_ident() == stage._thread and torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function("sctag." + name)
            self._range.__enter__()
        self._rec = stage if stage.spans is not None else None
        if self._rec is not None:
            self._begun = self._rec._begin()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self.name is not None:
            with _LOCK:
                self.stats.timers[self.name] += dt
        if self._rec is not None:
            self._rec._end(self.name or self._rec.stage, self._begun)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A span of the running stage (a no-op outside one), from any thread."""
    stats = _running
    return _Span(stats, name) if stats is not None else _NULL


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the running stage's counter ``name`` (any thread)."""
    stats = _running
    if stats is not None:
        stats.count(name, float(n))


@contextlib.contextmanager
def stage_scope(stage: str):
    """Counters, timers and spans around a stage body, emitted per
    SCTAG_STATS, and with SCTAG_PROFILE=<dir> a profiler trace of the body
    in <dir>."""
    global _running
    stats = StageStats(stage)
    profile_dir = os.environ.get("SCTAG_PROFILE")
    if os.environ.get("SCTAG_STATS") or profile_dir:
        stats.invocation = f"{os.getpid()}.{next(_invocations)}"
        stats.spans = []
    with _LOCK:
        outer, _running = _running, stats
    try:
        with _profiled(profile_dir, stats) if profile_dir else _NULL:
            root = _Span(stats, None)
            with root:
                stats._root = root._begun[0] if stats.spans is not None else None
                yield stats
    finally:
        with _LOCK:
            _running = outer
    stats.emit()


@contextlib.contextmanager
def _profiled(profile_dir: str, stats: StageStats):
    """torch.profiler around the body; the trace, with the worker threads'
    spans added, goes to <profile_dir>/<stage>.<pid>.<ns>.pt.trace.json
    (path on stderr)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(
        profile_dir, f"{stats.stage}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    )
    prof.export_chrome_trace(path)
    _add_worker_spans(path, stats.spans)
    print(f"[sctagger_tpu_torch] profile trace: {path}", file=sys.stderr)


def _add_worker_spans(path: str, spans: list[dict]) -> None:
    """Append the spans of threads other than the stage's to a Chrome trace
    as complete events on their own threads, on the trace's clock
    (``ts`` + ``baseTimeNanoseconds`` / 1000 is time_ns() / 1000)."""
    with _LOCK:
        workers = [s for s in spans if s["thread"] != "main"]
    if not workers:
        return
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    for tid, name in {s["tid"]: s["thread"] for s in workers}.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": name}})
    for s in workers:
        events.append({
            "ph": "X", "cat": "sctag_span", "name": "sctag." + s["name"],
            "pid": pid, "tid": s["tid"], "ts": (s["start_ns"] - base) / 1e3,
            "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
            "args": {"thread": s["thread"], "parent": s["parent"],
                     "invocation": s["invocation"]},
        })
    with open(path, "w") as f:
        json.dump(trace, f)


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
