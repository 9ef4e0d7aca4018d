"""Batch-granular part-file checkpointing (SURVEY.md §5, elastic recovery).

The reference's recovery unit is the whole stage (Snakemake re-runs a failed
rule from scratch). For very large inputs this module adds an optional finer
unit: set SCTAG_CHECKPOINT_DIR=<dir> and the heavy stages persist per-batch
intermediate results there; a re-run after a crash skips completed batches
and only recomputes the missing ones. Outputs are byte-identical with or
without checkpointing.

Two stage integrations:
  * match_trie: read batches are independent; each batch's output rows are a
    part file, concatenated in batch order (== global rid order).
  * extract_lr_bc: range detection is global, so what is checkpointed is the
    per-batch adapter-scan result (strand/dist/locs arrays as .npz); ranges,
    filtering, and writing re-run cheaply from the cached scans.

Part files are keyed by a digest of the stage inputs + parameters so stale
checkpoints from different inputs can never be reused.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
from typing import Iterable

import numpy as np


def checkpoint_dir() -> pathlib.Path | None:
    d = os.environ.get("SCTAG_CHECKPOINT_DIR")
    return pathlib.Path(d) if d else None


def job_key(stage: str, inputs: Iterable[str], params: dict) -> str:
    """Digest of input file identities (path, size, mtime) + parameters."""
    h = hashlib.sha256()
    h.update(stage.encode())
    for p in inputs:
        st = os.stat(p)
        h.update(f"{p}|{st.st_size}|{int(st.st_mtime)}".encode())
    h.update(json.dumps(params, sort_keys=True).encode())
    return h.hexdigest()[:16]


class PartStore:
    """Per-batch artifact store under <dir>/<stage>-<key>/part<i>.<ext>."""

    def __init__(self, stage: str, key: str):
        base = checkpoint_dir()
        self.enabled = base is not None
        if self.enabled:
            self.dir = base / f"{stage}-{key}"
            self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, i: int, ext: str) -> pathlib.Path:
        return self.dir / f"part{i:06d}.{ext}"

    def has(self, i: int, ext: str) -> bool:
        return self.enabled and self._path(i, ext).exists()

    # --- text parts (match_trie rows) -----------------------------------
    def load_text(self, i: int) -> str:
        return self._path(i, "tsv").read_text()

    def save_text(self, i: int, data: str) -> None:
        if not self.enabled:
            return
        tmp = self._path(i, "tsv").with_suffix(".tmp")
        tmp.write_text(data)
        tmp.replace(self._path(i, "tsv"))  # atomic completion marker

    def save_file(self, i: int, ext: str, write_fn) -> bool:
        """Part written straight to a file by ``write_fn(tmp_path) -> bool``
        (e.g. the native TSV formatter) and renamed into place on success —
        the rename stays the atomic completion marker. Returns False when
        disabled or when write_fn declines (caller falls back to save_text).
        """
        if not self.enabled:
            return False
        tmp = self._path(i, ext).with_suffix(".tmp")
        ok = bool(write_fn(str(tmp)))
        if ok:
            tmp.replace(self._path(i, ext))
        else:
            tmp.unlink(missing_ok=True)
        return ok

    # --- array parts (adapter-scan results) -----------------------------
    def load_arrays(self, i: int) -> dict:
        with np.load(self._path(i, "npz")) as z:
            return {k: z[k] for k in z.files}

    def save_arrays(self, i: int, **arrays) -> None:
        if not self.enabled:
            return
        tmp = self._path(i, "npz").with_suffix(".tmp.npz")
        np.savez_compressed(tmp, **arrays)
        tmp.replace(self._path(i, "npz"))
