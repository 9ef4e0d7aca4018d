"""Stage stats for the port: sctagger_tpu.observability.StageStats (JAX-free,
reused by import) without the jax.profiler branch of its stage_scope, so
SCTAG_PROFILE can never pull jax into the port."""

from __future__ import annotations

import contextlib

from sctagger_tpu.observability import StageStats


@contextlib.contextmanager
def stage_scope(stage: str):
    """Counters + timers around a stage body, emitted per SCTAG_STATS."""
    stats = StageStats(stage)
    yield stats
    stats.emit()
