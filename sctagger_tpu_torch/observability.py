"""Stage stats and progress for the port: sctagger_tpu.observability
.StageStats (JAX-free, reused by import) without the jax.profiler branch of
its stage_scope, so SCTAG_PROFILE can never pull jax into the port."""

from __future__ import annotations

import contextlib
import os
import sys

from sctagger_tpu.observability import StageStats
from sctagger_tpu.utils.misc import _NullBar


@contextlib.contextmanager
def stage_scope(stage: str):
    """Counters + timers around a stage body, emitted per SCTAG_STATS."""
    stats = StageStats(stage)
    yield stats
    stats.emit()


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
