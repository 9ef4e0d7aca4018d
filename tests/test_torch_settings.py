"""The port's settings: no environment variable chooses a code path. Each
stage picks its route from what it can observe (the device, the grid, the
adapter, the input), so the only SCTAG_* variables the package reads are
deployment and observability settings."""

import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1] / "sctagger_tpu_torch"

ALLOWED = {
    "SCTAG_DEVICE",  # cuda or cpu
    "SCTAG_CHECKPOINT_DIR", "SCTAG_CHECKPOINT_BATCH", "SCTAG_SR_BATCH_BYTES",
    "SCTAG_MAX_DEVICES", "SCTAG_VIRTUAL_DEVICES", "SCTAG_SYNC_TIMEOUT",
    "SCTAG_STATS", "SCTAG_PROFILE", "SCTAG_PROGRESS",
    "SCTAG_MODEL_PARALLEL",  # the mesh's model axis, until it is retired
    "SCTAG_BAM_THREADS",  # the BAM reader's threads (native/bam_reader.cpp, a copy)
}
RETIRED = re.compile(
    r"SCTAG_(STREAM|ADAPTER_D[012]|EXACT_PREFILTER|PREFILTER_D1|PROBE|PROBE_THREADS)\b"
)
READ = re.compile(
    r"""(?:environ(?:\.get)?\s*[\[(]\s*|getenv\s*\(\s*)["'](SCTAG_[A-Z0-9_]+)["']"""
)


def _sources(*globs):
    return [p for g in globs for p in sorted(ROOT.rglob(g))]


def test_env_reads_are_the_allowed_settings():
    reads = {}
    for path in _sources("*.py", "*.cpp", "*.h", "*.cu"):
        for name in READ.findall(path.read_text()):
            reads.setdefault(name, []).append(str(path.relative_to(ROOT)))
    assert {"SCTAG_DEVICE", "SCTAG_STATS", "SCTAG_BAM_THREADS"} <= set(reads)
    assert set(reads) <= ALLOWED, {k: v for k, v in reads.items() if k not in ALLOWED}


def test_retired_switches_are_gone():
    """Not read, and not named in code or notes either."""
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in _sources("*.py", "*.cpp", "*.h", "*.cu")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if RETIRED.search(line)]
    assert not hits, hits
