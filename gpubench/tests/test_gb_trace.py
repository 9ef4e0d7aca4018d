"""The reduction of a profiler trace: busy time as the union of device
activity inside the window, idle gaps labelled by the innermost host range."""

import json

import pytest

from gpubench import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize(tmp_path):
    events = [
        ev("gpubench.window", "user_annotation", 1000, 1000),
        ev("gpubench.match_trie", "user_annotation", 1000, 1000),
        ev("sctag_match_full", "user_annotation", 1100, 500),
        ev("void k1(int)", "kernel", 1200, 100),
        ev("void k1(int)", "kernel", 1250, 100),  # overlaps the first
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1500, 50),
        ev("void k2(int)", "kernel", 1900, 200),  # ends after the window
        ev("void k3(int)", "kernel", 100, 50),  # before the window
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(p)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((150 + 50 + 100) * 1e-6)
    assert s["kernels"] == {"void k1(int)": pytest.approx(200e-6), "void k2(int)": pytest.approx(100e-6)}
    assert s["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    # gaps 1000-1200, 1350-1500, 1550-1900, cut where sctag_match_full
    # (1100-1600) starts and ends
    gaps = sorted((name, round(g * 1e6)) for name, g in s["idle_gaps"])
    assert gaps == sorted([("gpubench.match_trie", 100), ("sctag_match_full", 100),
                           ("sctag_match_full", 150), ("sctag_match_full", 50),
                           ("gpubench.match_trie", 300)])
    assert round(s["idle_gaps"][0][1] * 1e6) == 300


def test_no_window_no_summary(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [ev("void k(int)", "kernel", 0, 5)]}))
    assert trace.summarize(p) == {}
