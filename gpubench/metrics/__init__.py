"""Metric readers: ``metrics/<metric>.py`` defines ``read(ctx)`` and
returns the metric's value, or None where the run holds nothing to read.

``ctx`` holds: ``unit`` (what the cell's rate counts), ``units`` (units
completed in the window), ``invocations``, ``window_s`` and ``setup_s``
(host clock), ``stats`` (the program's SCTAG_STATS records of the window's
invocations; traced runs only), ``prof`` (trace.summarize of the window;
traced runs only), ``summary`` (the stage's sizes) and ``config``."""

from __future__ import annotations


def timers(ctx, *keys) -> float | None:
    """Sum of the named timers over the window's records."""
    if not ctx.stats:
        return None
    vals = [r.get("timers_s", {}).get(k) for r in ctx.stats for k in keys]
    vals = [v for v in vals if v is not None]
    return float(sum(vals)) if vals else None


def counters(ctx, *keys) -> float | None:
    """Sum of the named counters (or PROF counts filed with the timers)."""
    if not ctx.stats:
        return None
    vals = []
    for r in ctx.stats:
        for k in keys:
            v = r.get("counters", {}).get(k, r.get("timers_s", {}).get(k))
            if v is not None:
                vals.append(v)
    return float(sum(vals)) if vals else None


def per_million(ctx, *keys) -> float | None:
    """Seconds of the named timers per million units."""
    t = timers(ctx, *keys)
    if t is None or not ctx.units:
        return None
    return t / (ctx.units / 1e6)


def percent(num, den) -> float | None:
    if num is None or not den:
        return None
    return 100.0 * num / den


def rate(ctx, unit: str) -> float | None:
    if ctx.unit != unit or not ctx.window_s:
        return None
    return ctx.units / ctx.window_s


def idle_pct(ctx) -> float | None:
    p = ctx.prof
    if not p or not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def kernel_seconds(ctx, pattern) -> float:
    """Device seconds of the kernels whose name matches ``pattern``."""
    if not ctx.prof:
        return 0.0
    return sum(v for k, v in ctx.prof.get("kernels", {}).items() if pattern.search(k))
