"""The span readers (gpubench/spans.py) and the metrics that read the
program's spans, on records written by hand: self time, sums, the untraced
share, and nothing read from records without spans."""

import types

import pytest

from gpubench import manifest, spans

MS = 1_000_000  # ns


def sp(sid, name, parent, start_ms, end_ms, thread="main"):
    return {"name": name, "id": sid, "parent": parent, "thread": thread, "tid": 1,
            "start_ns": start_ms * MS, "end_ns": end_ms * MS, "invocation": "7.0"}


def ctx(records, units=2_000_000):
    return types.SimpleNamespace(stats=records, units=units)


def rec(stage, *spans_):
    return {"stage": stage, "counters": {}, "timers_s": {}, "invocation": "7.0",
            "spans": list(spans_)}


MATCH = rec(
    "match_trie",
    sp(0, "match_trie", None, 0, 1000),
    sp(1, "read", 0, 0, 100),
    sp(2, "match.prep", 0, 50, 250, thread="match.prep_0"),
    sp(3, "match.prep", 0, 250, 400, thread="match.prep_0"),
    sp(4, "match.nb_build", 0, 120, 520, thread="match.nb_build"),
    sp(5, "match.prep_wait", 0, 100, 300),
    sp(6, "match.dispatch", 0, 300, 500),
    sp(7, "match.device_wait", 6, 450, 480),
    sp(8, "match.device_wait", 6, 470, 500),  # overlaps the one before
    sp(9, "match.dispatch", 0, 600, 700),
    sp(10, "write", 0, 800, 1000),
)


def test_self_time_less_the_union_of_main_thread_children():
    assert spans.self_s(ctx([MATCH]), "match.dispatch") == pytest.approx(0.15 + 0.1)
    # the workers run beside the root: they take nothing from it
    assert spans.self_s(ctx([MATCH]), "match_trie") == pytest.approx(0.2)
    assert spans.untraced_pct(ctx([MATCH])) == pytest.approx(20.0)


def test_children_clipped_to_their_parent():
    r = rec("s", sp(0, "s", None, 0, 100), sp(1, "a", 0, 0, 50), sp(2, "b", 1, 40, 70))
    assert spans.self_s(ctx([r]), "a") == pytest.approx(0.04)


def test_sums_over_records_and_names():
    c = ctx([MATCH, MATCH])
    assert spans.total_s(c, "match.prep") == pytest.approx(0.7)
    assert spans.total_s(c, "match.prep", "read") == pytest.approx(0.9)
    assert spans.total_s(c, "absent") is None
    assert spans.per_million(c, 0.7) == pytest.approx(0.35)


@pytest.mark.parametrize(
    "records", [[], None, [{"stage": "match_trie", "timers_s": {"read": 1.0}}]],
    ids=["empty", "untraced", "no-spans"])
def test_nothing_to_read(records):
    c = ctx(records)
    assert spans.total_s(c, "read") is None
    assert spans.self_s(c, "read") is None
    assert spans.untraced_pct(c) is None


LR = rec(
    "extract_lr_bc",
    sp(0, "extract_lr_bc", None, 0, 2000),
    sp(1, "stage.read_fastq", 0, 0, 900, thread="scan.parse"),
    sp(2, "adapter_scan", 0, 0, 1500),
    sp(3, "scan.parse_wait", 2, 0, 300),
    sp(4, "scan.parse_wait", 2, 400, 600),
    sp(5, "scan.d0probe_raw", 0, 300, 500, thread="scan.d0probe_0"),
    sp(6, "scan.d0probe", 2, 600, 700),
    sp(7, "stage.ranges_filter", 0, 1500, 1600),
    sp(8, "stage.write", 0, 1600, 1900),
)

ALT = rec(
    "extract_sr_bc_from_lr",
    sp(0, "extract_sr_bc_from_lr", None, 0, 1000),
    sp(1, "read_whitelist", 0, 0, 200),
    sp(2, "read_lr_tsv", 0, 200, 450),
    sp(3, "key_table", 0, 450, 600),
    sp(4, "probe", 0, 600, 800),
    sp(5, "probe.upload", 4, 600, 680),
    sp(6, "rank", 0, 800, 850),
    sp(7, "write", 0, 850, 900),
)

# metric -> (record, value read from two copies of it at 2M units)
READS = {
    "match.dispatch": (MATCH, 0.25),
    "match.prefilter_busy": (MATCH, 0.35),
    "match.nb_build": (MATCH, 0.4),
    "match.untraced": (MATCH, 20.0),
    "lr.parse_wait": (LR, 0.5),
    "lr.prefilter": (LR, 0.3),
    "lr.untraced": (LR, 5.0),
    "alt.read_lr_tsv": (ALT, 0.25),
    "alt.probe_upload": (ALT, 0.08),
    "alt.untraced": (ALT, 10.0),
}


@pytest.mark.parametrize("metric", list(READS))
def test_span_metrics(metric):
    record, want = READS[metric]
    reader = manifest.module("metrics", metric).read
    assert reader(ctx([record, record])) == pytest.approx(want)
    # a program that records no spans (timers alone): the metric is left out
    assert reader(ctx([{"stage": record["stage"], "timers_s": {"read_lr_tsv": 1.0}}])) is None
    assert reader(ctx([])) is None


def test_span_metrics_are_in_the_benchmark():
    names = {m["name"]: m for m in manifest.benchmark()["per_layer"]}
    for metric in READS:
        assert names[metric]["source"] == "program_span"
        assert names[metric]["workloads"] == [{"match": "sr25k.match.sub", "lr": "sr25k.lr.scan",
                                               "alt": "wl3m.alt.probe"}[metric.split(".")[0]]]
