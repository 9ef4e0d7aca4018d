"""The program's span records: each SCTAG_STATS record of a stage
invocation carries ``spans`` (name, id, parent, thread, start_ns, end_ns),
the stage itself the root (its name the record's ``stage``, no parent).

A span's self time is its duration minus the union of the intervals of its
children on the stage's own thread (``main``); a worker thread's span runs
beside its parent, so it takes nothing from it. Records without ``spans``
(a program that records none) read as nothing: every function returns None."""

from __future__ import annotations


def _records(ctx) -> list[dict]:
    return [r for r in (ctx.stats or []) if "spans" in r]


def _union_ns(intervals) -> int:
    total, cur = 0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def _self_ns(span: dict, spans: list[dict]) -> int:
    kids = [(max(k["start_ns"], span["start_ns"]), min(k["end_ns"], span["end_ns"]))
            for k in spans if k["parent"] == span["id"] and k["thread"] == "main"]
    kids = [(a, b) for a, b in kids if b > a]
    return span["end_ns"] - span["start_ns"] - _union_ns(kids)


def total_s(ctx, *names) -> float | None:
    """Seconds of the spans named ``names``, summed over the records."""
    recs = _records(ctx)
    if not recs:
        return None
    found = [s["end_ns"] - s["start_ns"] for r in recs for s in r["spans"]
             if s["name"] in names]
    return sum(found) / 1e9 if found else None


def self_s(ctx, name: str) -> float | None:
    """Self seconds of the spans named ``name``, summed over the records."""
    recs = _records(ctx)
    if not recs:
        return None
    found = [_self_ns(s, r["spans"]) for r in recs for s in r["spans"]
             if s["name"] == name]
    return sum(found) / 1e9 if found else None


def untraced_pct(ctx) -> float | None:
    """The stage's root spans' self time over their duration, in %: the
    share of an invocation on the stage's own thread inside no span."""
    own = dur = 0
    for r in _records(ctx):
        for s in r["spans"]:
            if s["parent"] is None and s["name"] == r.get("stage"):
                own += _self_ns(s, r["spans"])
                dur += s["end_ns"] - s["start_ns"]
    return 100.0 * own / dur if dur else None


def per_million(ctx, seconds: float | None) -> float | None:
    """``seconds`` per million of the cell's units."""
    if seconds is None or not ctx.units:
        return None
    return seconds / (ctx.units / 1e6)
