"""In-process multi-device execution (port of sctagger_tpu/parallel/mesh.py).

The JAX package lays every device chunk out over a ('data', 'model')
jax.sharding.Mesh with shard_map. The port has no shard_map: a mesh here is
a (data, model) grid of torch.devices, and each shard_* function launches
the one-device kernel on each slice, on that device's current stream inside
``torch.cuda.device(d)``, without syncing between slices, then merges the
slices with plain torch ops exactly as the JAX collectives do (pmin, psum,
all_gather). The names are the JAX module's, so each function's twin is
easy to find.

  data  axis : long reads / segments / probe rows
  model axis : whitelist patterns (match_trie only)

Outputs land on the grid's first device and are not synced.

Env knobs:
  SCTAG_MAX_DEVICES=N      cap the device list (0/unset = all cards)
  SCTAG_MODEL_PARALLEL=M   split the pattern axis M-way in match_trie (exact
                           merge; byte-identical output)
  SCTAG_VIRTUAL_DEVICES=N  a test and dry-run knob: the one resolved device
                           repeated N times, so a host with one card (or the
                           CPU) runs the split and the merge N-wide (the
                           counterpart of XLA's
                           --xla_force_host_platform_device_count)
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..runtime import resolve_device

# Observability: how many sharded dispatches ran and over how many grid
# cells (the multi-device dry run asserts the production path engaged).
STATS = {"sharded_calls": 0, "devices": 0}


class Mesh:
    """A (data, model) grid of torch.devices. ``shape`` is a dict with the
    keys 'data' and 'model', as a jax Mesh's is."""

    def __init__(self, devices):
        grid = [list(row) for row in devices]
        assert grid and all(len(r) == len(grid[0]) > 0 for r in grid), devices
        self.devices = grid
        self.shape = {"data": len(grid), "model": len(grid[0])}
        self.size = len(grid) * len(grid[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def compute_devices(device=None) -> list[torch.device]:
    """The devices a process computes on: every CUDA card when ``device``
    (runtime.resolve_device) is ``cuda`` without an index, else that one
    device; SCTAG_VIRTUAL_DEVICES=N repeats the one resolved device N times
    instead. Capped by SCTAG_MAX_DEVICES."""
    dev = resolve_device(device)
    n_virtual = int(os.environ.get("SCTAG_VIRTUAL_DEVICES", "0") or 0)
    if dev.type == "cuda" and dev.index is None:
        if n_virtual > 0:
            devs = [torch.device("cuda", torch.cuda.current_device())] * n_virtual
        else:
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [dev] * max(n_virtual, 1)
    cap = int(os.environ.get("SCTAG_MAX_DEVICES", "0") or 0)
    if cap > 0:
        devs = devs[:cap]
    return devs


def local_mesh(divisor: int = 0, model_parallel: int | None = None,
               device=None) -> Mesh | None:
    """(data, model) grid over compute_devices(device).

    Returns None when only one device is usable (callers then take their
    one-device path). ``divisor`` constrains the data-axis size to divide it
    (kernel block granularity); the largest usable device count wins.
    ``model_parallel`` defaults to SCTAG_MODEL_PARALLEL (1)."""
    devs = compute_devices(device)
    mp = (
        int(os.environ.get("SCTAG_MODEL_PARALLEL", "1") or 1)
        if model_parallel is None
        else model_parallel
    )
    n = len(devs)
    n -= n % mp
    while n >= mp and divisor > 0 and divisor % (n // mp):
        n -= mp
    if n // max(mp, 1) < 1 or n < 2:
        return None
    return _grid(devs[:n], mp)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """Explicit-size grid (tests / tools); asserts enough devices exist."""
    devs = compute_devices(device)
    n = len(devs) if n_devices is None else n_devices
    assert n <= len(devs), (n, len(devs))
    assert n % model_parallel == 0, (n, model_parallel)
    return _grid(devs[:n], model_parallel)


def _grid(devs: list, mp: int) -> Mesh:
    return Mesh([devs[i : i + mp] for i in range(0, len(devs), mp)])


def _count(mesh: Mesh) -> None:
    STATS["sharded_calls"] += 1
    STATS["devices"] = mesh.size


def _on(d: torch.device):
    """The launch context of device ``d``: its CUDA device (so copies,
    allocations and ctypes launches follow it), or nothing on the CPU."""
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


def _to(t: torch.Tensor, d: torch.device) -> torch.Tensor:
    """``t`` on ``d``, contiguous (the kernel wrappers require it; a slice
    already on ``d`` may not be)."""
    return t.to(d, non_blocking=True).contiguous()


def replicate(mesh: Mesh, *tensors) -> dict:
    """One copy of ``tensors`` per distinct data-axis device, made once:
    {device: (t0, t1, ...)} for shard_probe's key table."""
    out = {}
    for row in mesh.devices:
        d = row[0]
        if d not in out:
            with _on(d):
                out[d] = tuple(_to(t, d) for t in tensors)
    return out


# ---------------------------------------------------------------------------
# match_trie: dense segment x whitelist matching over the grid
# ---------------------------------------------------------------------------


def _data_slices(n: int, n_data: int, unit: int) -> list[tuple[int, int]]:
    """n_data equal [s, e) column ranges of an n-wide axis, n % (n_data *
    unit) == 0 (each slice keeps whole ``unit`` blocks)."""
    assert n % (n_data * unit) == 0, (n, n_data, unit)
    w = n // n_data
    return [(i * w, (i + 1) * w) for i in range(n_data)]


def _gather(mesh: Mesh, parts: list, dim: int) -> torch.Tensor:
    """Concatenate per-slice outputs on the grid's first device."""
    first = mesh.devices[0][0]
    with _on(first):
        return torch.cat([_to(t, first) for t in parts], dim=dim)


def _match_cells(mesh: Mesh, seg_T, peq_pm, br: int, bp: int, launch):
    """``launch(seg, peq, r0, r1)`` on every grid cell, on its device: reads
    [r0, r1) of seg_T (Ls, R) by the cell's data slice, pattern rows of
    peq_pm (P_pad, 8) by its model slice. Returns, per data slice, its
    model slices' outputs (unsynced) and each model slice's first pattern."""
    mp = mesh.shape["model"]
    rs = _data_slices(seg_T.shape[1], mesh.shape["data"], br)
    ps = _data_slices(peq_pm.shape[0], mp, bp if mp > 1 else 1)
    _count(mesh)
    cells = []
    for (r0, r1), grid_row in zip(rs, mesh.devices):
        local = []
        for (p0, p1), d in zip(ps, grid_row):
            with _on(d):
                local.append(launch(_to(seg_T[:, r0:r1], d), _to(peq_pm[p0:p1], d), r0, r1))
        cells.append((grid_row[0], local))
    return cells, [p0 for p0, _ in ps]


def shard_match_full(mesh: Mesh, seg_T, peq_pm, m: int, br: int | None = None,
                     maxlens=None) -> torch.Tensor:
    """K1 (match_full, or K2 match_full_dynls with ``maxlens``) with reads
    split over 'data' and the patterns replicated (model axis 1). seg_T:
    (Ls, R) with R % (n_data * br) == 0; maxlens (1, R // br) travels with
    its slice. Returns the (TIES_K + 2, R) rows on the first device,
    unsynced. For pattern-axis splits use shard_match_full_mp."""
    assert mesh.shape["model"] == 1, mesh.shape
    return shard_match_full_mp(mesh, seg_T, peq_pm, m, br=br, maxlens=maxlens)


def shard_match_full_mp(mesh: Mesh, seg_T, peq_pm, m: int, br: int | None = None,
                        bp: int | None = None, maxlens=None) -> torch.Tensor:
    """K1 over the (data, model) grid: reads split over 'data' AND patterns
    over 'model', merged exactly as the JAX package's shard_map body does.

    The per-slice rows do not commute naively (tie slots are collected
    against each slice's RUNNING min), but an exact merge exists:
      * global min = the min of the slices' mins;
      * a slice's count and slots are valid iff its min equals the global
        min (its hits are then exactly its at-global-min patterns);
      * global count = the sum of the valid counts (pattern ranges are
        disjoint);
      * global first-K slots = the K smallest of the valid slices' first-K
        lists rebased to global pattern ids: an id in the global first K
        has fewer than K at-min ids below it, so it is in its slice's first
        K.
    Rows are therefore bit-identical to the one-device kernel for every row
    the matcher consumes (pattern PADDING hits at min == m can differ in
    count across pad widths, but min == m > max_error rows are discarded).

    seg_T: (Ls, R), R % (n_data * br) == 0; peq_pm: (P_pad, 8), P_pad %
    (n_model * bp) == 0; maxlens (1, R // br) or None. Returns (TIES_K + 2,
    R) int32 on the first device, unsynced."""
    from ..ops.match_cuda import BIG, DEF_BP, DEF_BR, TIES_K, match_full, match_full_dynls

    br = DEF_BR if br is None else br
    if maxlens is not None:
        assert maxlens.shape[1] * br == seg_T.shape[1], (maxlens.shape, br)

    def launch(seg, peq, r0, r1):
        if maxlens is None:
            return match_full(seg, peq, m)
        return match_full_dynls(seg, peq, _to(maxlens[:, r0 // br : r1 // br], seg.device), m)

    cells, offs = _match_cells(mesh, seg_T, peq_pm, br, DEF_BP if bp is None else bp,
                               launch)
    rows = []
    for d0, local in cells:
        if len(local) == 1:
            rows.append(local[0])
            continue
        with _on(d0):
            stack = torch.stack([_to(o, d0) for o in local])  # (mp, K+2, r)
            gmin = stack[:, 0].amin(dim=0)
            valid = stack[:, 0] == gmin[None]
            gcnt = torch.where(valid, stack[:, 1], 0).sum(dim=0, dtype=torch.int32)
            off = torch.tensor(offs, dtype=torch.int32, device=d0)
            slots = stack[:, 2:]
            slots = torch.where(valid[:, None] & (slots < BIG),
                                slots + off[:, None, None], BIG)
            # valid ids are distinct across slices (disjoint pattern ranges),
            # so the K smallest sorted are the iterative min-extraction's
            cand = slots.reshape(len(local) * TIES_K, -1).sort(dim=0).values[:TIES_K]
            rows.append(torch.cat([gmin[None], gcnt[None], cand], dim=0))
    return _gather(mesh, rows, dim=1)


def shard_match_min(mesh: Mesh, seg_T, peq_pm, m: int, bp: int | None = None
                    ) -> torch.Tensor:
    """K4 (match_min) over the grid: reads over 'data', patterns over
    'model', the elementwise min over the model slices (min is exact, so the
    result equals the one-device call at any grid shape). seg_T: (Ls, R),
    R % n_data == 0; peq_pm: (P_pad, 8), P_pad % (n_model * bp) == 0, pad
    rows all zero (they score m, never below a real pattern). Returns the
    (1, R) int32 row on the first device, unsynced."""
    from ..ops.match_cuda import DEF_BP, match_min

    cells, _ = _match_cells(mesh, seg_T, peq_pm, 1, DEF_BP if bp is None else bp,
                            lambda seg, peq, r0, r1: match_min(seg, peq, m))
    rows = []
    for d0, local in cells:
        with _on(d0):
            best = local[0]
            for o in local[1:]:
                best = torch.minimum(best, _to(o, d0))
            rows.append(best)
    return _gather(mesh, rows, dim=1)


# ---------------------------------------------------------------------------
# extract_lr_bc: adapter scan over the grid (data axis only)
# ---------------------------------------------------------------------------


def _read_slices(mesh: Mesh, n: int):
    """(device, s, e) of each non-empty slice of ``n`` reads over 'data'
    (contiguous, sizes differ by at most 1; the kernels take any count)."""
    assert mesh.shape["model"] == 1, mesh.shape
    bounds = np.linspace(0, n, mesh.shape["data"] + 1).round().astype(int)
    return [(row[0], int(s), int(e)) for row, s, e in
            zip(mesh.devices, bounds[:-1], bounds[1:]) if e > s]


def shard_adapter_scan(mesh: Mesh, text, lens, peq, m: int) -> torch.Tensor:
    """K6 SLOTS (adapter_scan) with reads split over 'data'. text (B,
    row_bytes) uint8, lens (B,) int32, peq (2, 4) int32 (prep_peq). Returns
    the (12, B) rows on the first device, unsynced."""
    from ..ops.adapter_cuda import adapter_scan

    _count(mesh)
    outs = []
    for d, s, e in _read_slices(mesh, text.shape[0]):
        with _on(d):
            outs.append(adapter_scan(_to(text[s:e], d), _to(lens[s:e], d), peq, m))
    return _gather(mesh, outs, dim=1)


def shard_hw_block(mesh: Mesh, codes, lens, peq2, m: int):
    """The stage-1 exact mask fallback with reads split over 'data': K6 MASK
    (adapter_mask) for adapters of <= 32 bp, the plain multi-word hw_block
    above. codes (B, L) uint8 (L % 32 == 0), lens (B,) int32, peq2 the
    (5, 2) or (W, 5, 2) Peq of (adapter, reverse complement). Returns
    (d (B, 2) int32, bits (B, 2, L // 32) int32: argmin mask words) on the
    first device, unsynced."""
    from ..ops.adapter_cuda import adapter_mask, hw_block, pack_mask_bits, prep_peq
    from ..ops.myers import MAX_PATTERN_LEN

    peq2 = np.asarray(peq2)
    single = m <= MAX_PATTERN_LEN
    _count(mesh)
    ds, bits = [], []
    for d, s, e in _read_slices(mesh, codes.shape[0]):
        with _on(d):
            c, ln = _to(codes[s:e], d), _to(lens[s:e], d)
            if single:
                dd, bb = adapter_mask(c, ln, prep_peq(peq2), m)
                dd = dd.T
            else:
                dd, mask = hw_block(c.T.contiguous(), torch.from_numpy(peq2).to(d),
                                    ln.long(), m)
                dd, bb = dd.to(torch.int32), pack_mask_bits(mask)
            ds.append(dd)
            bits.append(bb)
    return _gather(mesh, ds, dim=0), _gather(mesh, bits, dim=0)


# ---------------------------------------------------------------------------
# extract_sr_bc_from_lr: exact whitelist probe over the grid
# ---------------------------------------------------------------------------


def shard_probe(mesh: Mesh, tables: dict, packed, lens, k: int, L: int):
    """probe_rows_packed with query rows split over 'data' and the key table
    replicated: ``tables`` is replicate(mesh, sorted_keys, values), made
    once per stage. packed (n, L // 4) uint8, lens (n,) int32. Returns
    (count, single_val) (n,) int32 on the first device, unsynced."""
    from ..ops.exact_lookup import probe_rows_packed

    _count(mesh)
    cs, vs = [], []
    for d, s, e in _read_slices(mesh, packed.shape[0]):
        with _on(d):
            sk, vv = tables[d]
            c, v = probe_rows_packed(sk, vv, _to(packed[s:e], d), _to(lens[s:e], d), k, L)
            cs.append(c)
            vs.append(v)
    return _gather(mesh, cs, dim=0), _gather(mesh, vs, dim=0)
