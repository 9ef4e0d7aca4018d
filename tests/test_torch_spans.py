"""The port's spans and counts (sctagger_tpu_torch/observability.py): one
invocation id and a parent for every span, worker threads included; counts
in ``counters``, never in ``timers_s``; a profiler range only while
torch.profiler runs; worker spans on the trace's clock and, under
SCTAG_PROFILE, on their own threads of the trace file; and each stage's
SCTAG_STATS record holding the timers and counters the benchmark reads
(gpubench/metrics) with the spans beside them (CPU)."""

import gzip
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from gpubench import manifest
from gpubench import spans as gb_spans
from gpubench.stages import match_trie as gb_match
from gpubench.traffic import ont_segments
from sctagger_tpu_torch import observability as obs
from sctagger_tpu_torch.cli import main as torch_main
from sctagger_tpu_torch.core.packing import rev_compl
from sctagger_tpu_torch.models import matcher

torch.set_num_threads(1)

ADAPTER = "CTACACGACGCTCTTCCGATCT"


@pytest.fixture
def stats_file(tmp_path, monkeypatch):
    path = tmp_path / "stats.jsonl"
    monkeypatch.setenv("SCTAG_STATS", str(path))
    monkeypatch.delenv("SCTAG_PROFILE", raising=False)
    return path


def _records(path) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln]


def _in_worker(name: str, fn) -> None:
    t = threading.Thread(target=fn, name=name)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def _worker_work():
    with obs.span("w.work"):
        time.sleep(0.02)


def test_worker_and_main_spans_share_the_invocation(stats_file):
    with obs.stage_scope("s") as st:
        with obs.span("outer"):
            with st.timer("inner"):
                time.sleep(0.02)
            _in_worker("w", _worker_work)
            time.sleep(0.01)
    (rec,) = _records(stats_file)
    by = {s["name"]: s for s in rec["spans"]}
    assert set(by) == {"s", "outer", "inner", "w.work"}
    assert {s["invocation"] for s in rec["spans"]} == {rec["invocation"]}
    assert rec["invocation"].startswith(f"{os.getpid()}.")
    root = by["s"]
    assert root["parent"] is None and root["thread"] == "main"
    assert by["outer"]["parent"] == root["id"] and by["outer"]["thread"] == "main"
    assert by["inner"]["parent"] == by["outer"]["id"]
    # a worker opens no span of the stage's thread: its parent is the stage
    assert by["w.work"]["parent"] == root["id"] and by["w.work"]["thread"] == "w"
    assert by["w.work"]["tid"] != root["tid"]
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    assert set(rec["timers_s"]) == {"outer", "inner", "w.work"}

    # self time: the span less its children on the stage's thread (the
    # worker runs beside it and takes nothing from it)
    ctx = type("Ctx", (), {"stats": [rec], "units": 1e6})
    dur = {k: (s["end_ns"] - s["start_ns"]) / 1e9 for k, s in by.items()}
    assert gb_spans.self_s(ctx, "outer") == pytest.approx(dur["outer"] - dur["inner"])
    assert gb_spans.self_s(ctx, "outer") >= 0.01 + dur["w.work"] * 0.5
    assert gb_spans.total_s(ctx, "w.work") == pytest.approx(dur["w.work"])


def test_counts_land_in_counters_only(stats_file):
    obs.count("x.before", 1)  # no stage running: nothing, no error
    with obs.span("x.t"):
        pass
    with obs.stage_scope("s") as st:
        obs.count("x.reads", 3)
        obs.count("x.reads", np.int64(2))
        st.count("x.rows", 4)
        _in_worker("w", lambda: obs.count("x.worker", 5))
        with obs.span("x.t"):
            pass
    (rec,) = _records(stats_file)
    assert rec["counters"] == {"x.reads": 5.0, "x.rows": 4.0, "x.worker": 5.0}
    assert set(rec["timers_s"]) == {"x.t"}
    assert not set(rec["counters"]) & set(rec["timers_s"])


def test_bare_stage_stats_record_has_no_spans(stats_file):
    st = obs.StageStats("s")
    with st.timer("t"):
        pass
    st.emit()
    (rec,) = _records(stats_file)
    assert set(rec) == {"stage", "wall_s", "counters", "timers_s"}


def test_no_range_while_the_profiler_is_off(stats_file, monkeypatch):
    def _raise(*a, **k):
        raise AssertionError("record_function called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    with obs.stage_scope("s") as st:
        with obs.span("a"), st.timer("b"):
            _in_worker("w", _worker_work)
    (rec,) = _records(stats_file)
    assert {s["name"] for s in rec["spans"]} == {"s", "a", "b", "w.work"}


def test_worker_span_on_the_trace_clock(stats_file, tmp_path):
    """Under torch.profiler a main-thread span is a range of the trace; a
    worker span inside it, converted by the trace's baseTimeNanoseconds,
    lies inside that range (to 1 ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.stage_scope("s"):
            with obs.span("outer"):
                time.sleep(0.005)
                _in_worker("w", _worker_work)
                time.sleep(0.005)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"sctag.s", "sctag.outer"} <= names and "sctag.w.work" not in names
    (outer,) = [e for e in trace["traceEvents"] if e.get("name") == "sctag.outer"]
    (rec,) = _records(stats_file)
    (w,) = [s for s in rec["spans"] if s["name"] == "w.work"]
    lo, hi = (w["start_ns"] - base) / 1e3, (w["end_ns"] - base) / 1e3
    assert float(outer["ts"]) - 1000 <= lo < hi <= float(outer["ts"]) + float(outer["dur"]) + 1000
    assert hi - lo >= 0.02 * 1e6 * 0.9


def test_profile_trace_holds_worker_spans_on_their_threads(tmp_path, monkeypatch):
    monkeypatch.delenv("SCTAG_STATS", raising=False)
    monkeypatch.setenv("SCTAG_PROFILE", str(tmp_path / "prof"))
    with obs.stage_scope("probe_stage"):
        with obs.span("main.phase"):
            _in_worker("w", _worker_work)
    (path,) = (tmp_path / "prof").glob("probe_stage.*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (stage,) = [e for e in events if e.get("name") == "sctag.probe_stage"]
    (phase,) = [e for e in events if e.get("name") == "sctag.main.phase"]
    (work,) = [e for e in events if e.get("name") == "sctag.w.work"]
    assert phase["tid"] == stage["tid"] and work["tid"] != stage["tid"]
    assert work["ph"] == "X" and work["args"]["thread"] == "w"
    assert stage["ts"] <= work["ts"] and work["dur"] > 0
    assert any(e.get("ph") == "M" and e.get("tid") == work["tid"]
               and e["args"]["name"] == "w" for e in events)


# --- the stages: what gpubench/metrics reads, and the new spans ---------------

def _dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def _sub(rng, s: str, k: int) -> str:
    b = list(s)
    for at in rng.choice(len(b), size=k, replace=False):
        b[at] = "ACGT"[("ACGT".index(b[at]) + 1 + int(rng.integers(3))) % 4]
    return "".join(b)


def _match_argv(tmp, rng):
    bcs = sorted({_dna(rng, 16) for _ in range(200)})
    (tmp / "sr.tsv").write_text("".join(f"{b}\t{10}\n" for b in bcs))
    rows = []
    for i in range(3000):
        if rng.random() < 0.3:
            seg = _dna(rng, 24)  # no barcode: the device sweep's read
        else:
            seg = _dna(rng, 4) + _sub(rng, bcs[int(rng.integers(len(bcs)))],
                                      int(rng.integers(3))) + _dna(rng, 4)
        rows.append(f"r{i}\t1\t5\t{seg}\n")
    (tmp / "lr.tsv").write_text("".join(rows))
    return ["match_trie", "-lr", str(tmp / "lr.tsv"), "-sr", str(tmp / "sr.tsv"),
            "-mr", "2", "-o", str(tmp / "out.tsv")]


def _ont_argv(tmp, rng):
    """The sr25k.match.ont cell's traffic at a small size: ragged
    filter_aln cuts with indels, from both strands."""
    spec = manifest.cell("sr25k.match.ont")
    config = {**spec["config_data"], "segments_per_invocation": 3000,
              "whitelist_barcodes": 300}
    params = {**spec["workload"]["params"], "warm_rows": 200}
    data = ont_segments.generate(params, config, int(rng.integers(1 << 31)))
    files = gb_match.write_inputs(data, config, params, tmp)
    return gb_match.argv(files, config, tmp / "out.tsv.gz", warm=False)


def _lr_argv(tmp, rng):
    recs = []
    for i in range(400):
        seq = _dna(rng, int(rng.integers(200, 600)))
        r = rng.random()
        if r < 0.4:
            p = int(rng.integers(0, 20))
            seq = seq[:p] + _sub(rng, ADAPTER, int(rng.integers(2))) + seq[p:]
        elif r < 0.8:
            p = len(seq) - int(rng.integers(0, 20))
            seq = seq[:p] + rev_compl(ADAPTER) + seq[p:]
        recs.append(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    (tmp / "r.fastq").write_text("".join(recs))
    return ["extract_lr_bc", "-r", str(tmp / "r.fastq"), "-o", str(tmp / "lr.tsv.gz")]


def _alt_argv(tmp, rng, ending="\n"):
    wl = sorted({_dna(rng, 16 + 1 - len(ending)) for _ in range(300)})
    (tmp / "wl.txt.gz").write_bytes(gzip.compress("".join(b + ending for b in wl).encode()))
    rows = []
    for i in range(1000):
        if rng.random() < 0.1:
            rows.append(f"r{i}\t-1\tNA\t\n")
            continue
        bc = wl[int(rng.integers(0, 40))]
        bc = rev_compl(bc) if rng.random() < 0.5 else bc
        rows.append(f"r{i}\t1\t5\t{_dna(rng, 4)}{bc}{_dna(rng, 4)}\n")
    (tmp / "lr.tsv.gz").write_bytes(gzip.compress("".join(rows).encode()))
    return ["extract_sr_bc_from_lr", "-i", str(tmp / "lr.tsv.gz"), "-wl",
            str(tmp / "wl.txt.gz"), "-o", str(tmp / "alt.tsv.gz")]


# stage -> (argv maker, env ({tmp}: the test's directory), timers, counters,
# spans on worker threads by their thread's name prefix); the timers and
# counters of gpubench/metrics/*.py, then this module's new spans. The
# one_shot route is the checkpointed one (the FASTQ read whole); the alt
# stage takes its device probe on a grid of two CPU devices.
STAGES = {
    "match_trie": (
        _match_argv, {},
        ["read", "write", "match.prep_wait", "match.device_wait", "match.ties",
         "match.prep", "match.nb_build", "match.dispatch"],
        ["prefilter_resolved", "reads", "device_reads"],
        {"match.prep": "match.prep", "match.nb_build": "match.nb_build"},
    ),
    "match_trie.ont": (
        _ont_argv, {},
        ["read", "write", "match.prep_wait", "match.device_wait", "match.ties",
         "match.prep", "match.nb_build", "match.dispatch"],
        ["prefilter_d1_resolved", "prefilter_d1_indel", "device_chunks_ragged",
         "sweep_cells", "sweep_pad_cells"],
        {"match.prep": "match.prep", "match.nb_build": "match.nb_build"},
    ),
    "extract_lr_bc": (
        _lr_argv, {},
        ["stage.read_fastq", "adapter_scan", "stage.ranges_filter", "stage.write",
         "scan.parse_wait", "scan.d0probe_raw", "scan.d0probe"],
        ["scan.kernel_reads", "reads"],
        {"stage.read_fastq": "scan.parse", "scan.d0probe_raw": "scan.d0probe"},
    ),
    "extract_lr_bc.one_shot": (
        _lr_argv, {"SCTAG_CHECKPOINT_DIR": "{tmp}/ckpt"},
        ["read_fastq", "adapter_scan", "stage.ranges_filter", "stage.write"],
        ["scan.kernel_reads", "scan.d1_resolved_reads", "reads"], {},
    ),
    "extract_sr_bc_from_lr": (
        _alt_argv, {"SCTAG_VIRTUAL_DEVICES": "2"},
        ["read_whitelist", "read_lr_tsv", "key_table", "probe", "rank", "write",
         "probe.upload", "key_table.encode", "key_table.build"],
        ["key_table.entries", "whitelist.fixed_stride", "whitelist.bytes"], {},
    ),
}


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_records_what_the_benchmark_reads(tmp_path, stats_file, monkeypatch, stage):
    make, env, timers, counters, workers = STAGES[stage]
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    monkeypatch.setenv("SCTAG_PROGRESS", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(tmp=tmp_path))
    # several slices of the match's streaming layout (prep worker, index)
    monkeypatch.setattr(matcher, "PASS1_CHUNK", 1024)
    torch_main(make(tmp_path, np.random.default_rng(5)))
    (rec,) = _records(stats_file)
    assert rec["stage"] == stage.split(".")[0]
    assert set(timers) <= set(rec["timers_s"]), sorted(rec["timers_s"])
    assert set(counters) <= set(rec["counters"]), sorted(rec["counters"])
    assert all(rec["counters"][k] > 0 for k in counters)
    if stage == "extract_sr_bc_from_lr":  # the key table is built where it is probed
        assert rec["counters"]["probe.uploads"] == rec["counters"]["probe.upload_bytes"] == 0
        assert rec["counters"]["whitelist.fixed_stride"] == 1
    assert not set(rec["counters"]) & set(rec["timers_s"])
    names = {s["name"] for s in rec["spans"]}
    assert set(rec["timers_s"]) <= names
    assert {s["invocation"] for s in rec["spans"]} == {rec["invocation"]}
    ids = {s["id"] for s in rec["spans"]}
    roots = [s for s in rec["spans"] if s["parent"] is None]
    assert [s["name"] for s in roots] == [rec["stage"]]
    assert all(s["parent"] in ids for s in rec["spans"] if s["parent"] is not None)
    for name, thread in workers.items():
        got = {s["thread"] for s in rec["spans"] if s["name"] == name}
        assert got and all(t.startswith(thread) for t in got), (name, got)
    ctx = type("Ctx", (), {"stats": [rec], "units": 1e6})
    assert 0.0 <= gb_spans.untraced_pct(ctx) < 100.0


@pytest.mark.parametrize("ending,fixed", [("\n", 1), ("\r\n", 0)], ids=["lf", "crlf"])
def test_alt_whitelist_fixed_stride_counter(tmp_path, stats_file, monkeypatch, ending, fixed):
    """15 bp words with \\r\\n endings fill the same 17-byte stride as 16 bp
    words with \\n: the buffer read takes both, the key table refuses the \\r,
    and the stage reads the lines again."""
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    monkeypatch.setenv("SCTAG_PROGRESS", "0")
    monkeypatch.setenv("SCTAG_VIRTUAL_DEVICES", "2")  # the device probe
    torch_main(_alt_argv(tmp_path, np.random.default_rng(6), ending))
    (rec,) = _records(stats_file)
    assert rec["counters"]["whitelist.fixed_stride"] == fixed
    raw = gzip.decompress((tmp_path / "wl.txt.gz").read_bytes())
    assert rec["counters"]["whitelist.bytes"] == len(raw) == 17 * raw.count(b"\n")


def test_match_gz_write_counters_inside_the_write_span(tmp_path, stats_file, monkeypatch):
    """A gz match output in several members, written by several threads:
    the writer's counters say so, ``write.raw_bytes`` is the decompressed
    size, and the whole writer call lies inside the stage's ``write`` span."""
    from sctagger_tpu_torch.io import match_writer
    from sctagger_tpu_torch.stages import match_trie as stage

    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    monkeypatch.setenv("SCTAG_PROGRESS", "0")
    monkeypatch.setattr(match_writer, "BLOCK_BYTES", 8 << 10)
    monkeypatch.setattr(match_writer, "_cores", lambda: 4)
    calls = []

    def _timed(*a, **k):
        t0 = time.time_ns()
        ok = match_writer.write_match_tsv(*a, **k)
        calls.append((t0, time.time_ns()))
        return ok

    monkeypatch.setattr(stage, "write_match_tsv", _timed)
    torch_main(_ont_argv(tmp_path, np.random.default_rng(7)))
    (rec,) = _records(stats_file)
    raw = gzip.decompress((tmp_path / "out.tsv.gz").read_bytes())
    c = rec["counters"]
    assert c["write.raw_bytes"] == len(raw) > 3 * (8 << 10)
    assert c["write.members"] > 3 and c["write.threads"] == 4
    (write,) = [s for s in rec["spans"] if s["name"] == "write"]
    ((t0, t1),) = calls
    assert write["start_ns"] <= t0 < t1 <= write["end_ns"]
