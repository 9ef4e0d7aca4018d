"""Reduction of the torch.profiler trace of a run's window.

The window is the benchmark's ``gpubench.window`` range. Device activity is
every kernel, copy and set on the card; its union is the busy time. Idle
gaps are the spaces between, cut where a host range starts or ends, each
piece labelled by the innermost host range that covers it (the benchmark's
span around each invocation, or a range of the program's own)."""

from __future__ import annotations

import json
import re

import numpy as np

WINDOW = "gpubench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return re.sub(r"^void ", "", name).strip()[:160]


def summarize(path) -> dict:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    starts = np.array([float(e["ts"]) for e in dev])
    ends = starts + np.array([float(e["dur"]) for e in dev])
    inside = (ends > w0) & (starts < w1)
    kernels: dict[str, float] = {}
    ops: dict[str, float] = {}
    for e, s, t, ok in zip(dev, starts, ends, inside):
        if not ok:
            continue
        sec = (min(t, w1) - max(s, w0)) / 1e6
        ops[_short(e["name"])] = ops.get(_short(e["name"]), 0.0) + sec
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + sec
    s, t = np.clip(starts[inside], w0, w1), np.clip(ends[inside], w0, w1)
    order = np.argsort(s)
    s, t = s[order], t[order]
    busy = 0.0
    gaps = []
    cur = w0
    for a, b in zip(s, t):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    host = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") != WINDOW]
    h0 = np.array([float(e["ts"]) for e in host])
    h1 = h0 + np.array([float(e["dur"]) for e in host])
    pieces = []
    for a, b in gaps:
        cuts = np.concatenate([[a, b], h0[(h0 > a) & (h0 < b)], h1[(h1 > a) & (h1 < b)]])
        cuts = np.unique(cuts)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            mid = (lo + hi) / 2
            cover = np.flatnonzero((h0 <= mid) & (h1 >= mid)) if host else []
            name = (WINDOW if len(cover) == 0
                    else host[cover[np.argmin(h1[cover] - h0[cover])]]["name"])
            if pieces and pieces[-1][0] == name and pieces[-1][2] == lo:
                pieces[-1][2] = hi
            else:
                pieces.append([name, lo, hi])
    longest = sorted(pieces, key=lambda p: p[1] - p[2])[:TOP]
    labelled = [[name, (hi - lo) / 1e6] for name, lo, hi in longest]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "kernels": kernels,
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": labelled,
    }
