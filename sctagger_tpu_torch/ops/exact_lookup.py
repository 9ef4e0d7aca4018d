"""Exact multi-pattern k-mer lookup for the alt stage (torch port of
sctagger_tpu/ops/exact_lookup.py; replaces pyahocorasick, scTagger.py:801-826).

All reference patterns are fixed-length barcodes (16 bp), so Aho-Corasick
degenerates to "is this window in the dictionary": every k-length window of
a segment packs into one integer (2 bits/base) and probes a sorted key
table.

Dictionary semantics reproduced exactly:
  * values: forward barcode i -> i, revcomp -> -i, added in that order with
    later adds OVERWRITING (a word that is both some forward barcode and some
    revcomp keeps the revcomp value, scTagger.py:803-807);
  * a window containing any non-ACGT byte matches nothing (exact char match);
  * per segment, >1 window hit => ambiguous (handled by the caller).

The key table (``build_key_table``) is built in torch on the device the
probe runs on: the whitelist's bytes as the stage read them (one buffer,
io/whitelist.py) or one host join of its words, then the 2-bit codes, the
fwd and rc keys, a stable sort and keep-last on that device. Keys and
values are int64 tensors (torch's uint32 support is thin); the stage
builds them on its device: on the card for the device probe, which takes
them where they are (no upload), and on the CPU for the host probe, which
reads them as numpy views.

Two probes; ``probe_segments`` takes the one that fits its device:
  * the device probe, on a card or on a grid of several devices
    (parallel/mesh.py): 2-bit-packed rows up, a binary search of every
    window in the sorted key table (``torch.searchsorted``) and the per-row
    reduction on the device, (count, single value) per row down. Rows with
    in-sequence non-ACGT bytes cannot ride the 2-bit pack; they get length
    0 on the device and go through the host probe (the table copied down
    for them alone);
  * the host probe, on one CPU device: the native threaded hash probe over
    the raw segment bytes (native/exact_probe.cpp).
Neither probe falls back to the other: a failure raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.packing import (
    STRICT_TABLE,
    encode_rows,
    seq_lengths,
)
from ..observability import count, span
from ..runtime import resolve_device
from ..utils import round_up

PROBE_CHUNK = 65536  # rows per device probe step, at most
HOST_PROBE_THREADS = 2  # native threads of the host probe
_ROW_BUDGET = 1 << 23  # rows x padded length per device step (int64 windows)


def build_key_table(words_fwd, words_rc: list[str] | None = None, device=None):
    """Pack fwd (values +i) then rc (values -i) words; later entries win.

    Returns (sorted_keys, values), int64 tensors on ``device`` (the CPU when
    None). Raises ValueError if any word is not pure uppercase ACGT of
    uniform length <= 16 (callers fall back to the host dict path).
    ``words_rc=None`` (the production stage) packs each rc key beside its
    fwd key: no rc strings are ever built.

    ``words_fwd`` is a list of str, or io.whitelist.FixedStrideWords (with
    ``words_rc=None``), whose buffer is taken as it is. A list is joined,
    each word followed by a newline: the only host pass. The 2-bit codes,
    keys, sort and keep-last run on ``device``. The newline column proves
    the words uniform: a ragged list cannot put a newline at every
    (k + 1)-th byte and only ACGT in between.
    """
    n = len(words_fwd)
    k = len(words_fwd[0]) if n else 0
    if n == 0 or k == 0 or k > 16:
        raise ValueError("empty or overlong whitelist; use host fallback")
    dev = torch.device("cpu" if device is None else device)
    m = n if words_rc is None else n + len(words_rc)
    with span("key_table.encode"):
        blob = getattr(words_fwd, "buf", None)  # FixedStrideWords: no join
        if blob is None:
            words = words_fwd if words_rc is None else words_fwd + words_rc
            try:
                blob = bytearray("\n".join(words + [""]), "latin-1")
            except UnicodeEncodeError:
                raise ValueError("non-latin-1 whitelist; use host fallback")
        if len(blob) != m * (k + 1):
            raise ValueError("ragged whitelist; use host fallback")
    with span("key_table.build"):
        rows = torch.frombuffer(blob, dtype=torch.uint8).to(dev).view(m, k + 1)
        lut = torch.from_numpy(STRICT_TABLE).to(dev)
        bad = rows[:, k] != ord("\n")
        fwd = torch.zeros(m, dtype=torch.int64, device=dev)
        rc = torch.zeros(m if words_rc is None else 0, dtype=torch.int64, device=dev)
        for i in range(k):  # char 0 in the top bits; the rc key's at the bottom
            c = torch.index_select(lut, 0, rows[:, i].int())  # 4: not ACGT
            bad |= c > 3
            fwd.bitwise_left_shift_(2).bitwise_or_(c)
            if words_rc is None:
                rc.bitwise_or_((c ^ 3).long() << (2 * i))
        del rows
        if bool(bad.any()):
            raise ValueError("non-ACGT or ragged whitelist; use host fallback")
        keys = torch.cat([fwd, rc])
        del fwd, rc
        keys, order = torch.sort(keys, stable=True)
        last = torch.ones_like(keys, dtype=torch.bool)  # keep-LAST of each run
        last[:-1] = keys[1:] != keys[:-1]
        keys, order = keys[last], order[last]
        values = torch.where(order < n, order, n - order)  # rc i sits at n + i
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    count("key_table.entries", keys.numel())
    count("key_table.overwritten", last.numel() - keys.numel())
    count("key_table.on_device", int(dev.type == "cuda"))
    return keys, values


def probe_rows_packed(sorted_keys: torch.Tensor, values: torch.Tensor,
                      packed: torch.Tensor, lens: torch.Tensor, k: int,
                      L: int):
    """Per-row (count, single value) of the k-windows of 2-bit-packed rows
    (JAX: ``_probe_rows_packed``), on the tensors' device.

    sorted_keys (K,) int64 ascending, values (K,) int64; packed (n, L // 4)
    uint8 with char 4j + t in bits 2t..2t+1 of byte j; lens (n,) int32, a
    row's windows past its length never hit. Window keys put the window's
    first char in the top bits, as the key table does. Returns (count,
    single_val) int32, single_val the hit's value when count == 1, else 0.
    """
    n = packed.shape[0]
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(n, -1)[:, :L]
    w = L - k + 1
    key = torch.zeros((n, w), dtype=torch.int64, device=packed.device)
    for i in range(k):  # rolling keys, char 0 in the top bits
        key = (key << 2) | codes[:, i : w + i]
    pos = torch.arange(w, dtype=torch.int32, device=packed.device)
    valid = (pos[None, :] + k) <= lens[:, None]
    at = torch.searchsorted(sorted_keys, key).clamp_(max=sorted_keys.numel() - 1)
    hit = (sorted_keys[at] == key) & valid
    val = torch.where(hit, values[at], 0)
    c = hit.sum(dim=1, dtype=torch.int32)
    sv = torch.where(c == 1, val.sum(dim=1), 0).to(torch.int32)
    return c, sv


def probe_segments(segments, sorted_keys: torch.Tensor, values: torch.Tensor,
                   k: int, chunk: int = PROBE_CHUNK, device=None):
    """For each segment: (n_hits, value of the single hit or 0).

    ``sorted_keys``, ``values``: build_key_table's tensors, on any device.
    Hits are counted over every k-window. Returns (counts (N,), single_val
    (N,)) int64 numpy arrays, single_val meaningful only where counts == 1.
    The probe follows ``device`` (runtime.resolve_device; module note): the
    device probe on a card or a grid of several devices, the host probe on
    one CPU device.
    """
    from ..parallel.mesh import local_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" or local_mesh(model_parallel=1, device=dev) is not None:
        return _probe_segments_device(segments, sorted_keys, values, k, chunk, dev)
    return _probe_rows_host(segments, sorted_keys, values, k)


def _probe_segments_device(segments, sorted_keys, values, k, chunk, dev):
    """The device probe driver: per step, one native encode + 2-bit pack of
    up to ``chunk`` rows, probe_rows_packed on ``dev``, the per-row results
    copied back. Junk rows (in-sequence non-ACGT) go to the host probe.
    With several devices (parallel/mesh.py) each step holds ``chunk`` rows
    per data slice and splits over the grid, the key table copied to each
    device once. A table already on ``dev`` is not copied."""
    from ..parallel.mesh import local_mesh, replicate, shard_probe

    n = len(segments)
    counts = np.zeros(n, dtype=np.int64)
    single_val = np.zeros(n, dtype=np.int64)
    if n == 0:
        return counts, single_val
    L = round_up(max(int(seq_lengths(segments).max()), k), 4)  # L % 4 == 0
    rows = max(1, min(chunk, _ROW_BUDGET // L))
    mesh = local_mesh(model_parallel=1, device=dev)
    with span("probe.upload"):
        if mesh is not None:
            rows *= mesh.shape["data"]
            tables = replicate(mesh, sorted_keys, values)
            placed = [sk for sk, _ in tables.values()]
        else:
            sk, vv = sorted_keys.to(dev), values.to(dev)
            placed = [sk]
    uploads = sum(t is not sorted_keys for t in placed)  # .to() keeps a tensor in place
    count("probe.uploads", uploads)
    count("probe.upload_bytes", uploads * (sorted_keys.nbytes + values.nbytes))
    enc_packed = getattr(segments, "encode_packed", None)
    junk_rows: list[np.ndarray] = []
    for s in range(0, n, rows):
        idx = np.arange(s, min(s + rows, n), dtype=np.int64)
        if enc_packed is not None:
            pk, lens, junk = enc_packed(idx, pad_to=L, table=STRICT_TABLE)
        else:
            codes, lens = encode_rows(segments, idx, pad_to=L, table=STRICT_TABLE)
            in_len = np.arange(L)[None, :] < lens[:, None]
            junk = ((codes > 3) & in_len).any(axis=1)
            c4 = (codes & 3).astype(np.uint8).reshape(idx.size, L // 4, 4)
            pk = c4[:, :, 0] | (c4[:, :, 1] << 2) | (c4[:, :, 2] << 4) | (c4[:, :, 3] << 6)
        lens = np.where(junk, 0, lens).astype(np.int32)
        if junk.any():
            junk_rows.append(idx[junk])
        pk_t = torch.from_numpy(np.ascontiguousarray(pk))
        if mesh is not None:
            c, v = shard_probe(mesh, tables, pk_t, torch.from_numpy(lens), k, L)
        else:
            c, v = probe_rows_packed(
                sk, vv, pk_t.to(dev), torch.from_numpy(lens).to(dev), k, L
            )
        counts[idx] = c.cpu().numpy()
        single_val[idx] = v.cpu().numpy()
    if junk_rows:
        jr = np.concatenate(junk_rows)
        jc, jv = _probe_rows_host(  # the table comes down only here
            [segments[int(i)] for i in jr], sorted_keys, values, k
        )
        counts[jr] = jc
        single_val[jr] = jv
    return counts, single_val


def _probe_rows_host(segments, sorted_keys: torch.Tensor, values: torch.Tensor,
                     k: int):
    """Native threaded hash probe over raw segment bytes (exact_probe.cpp);
    the table's tensors are read on the host (a view when on the CPU)."""
    from ..native import build as native_build

    lib = native_build.load()
    n = len(segments)
    sorted_keys, values = sorted_keys.cpu().numpy(), values.cpu().numpy()
    if values.size and int(np.abs(values).max()) >= 2**31:
        raise ValueError("values exceed int32 (hash table layout)")
    # open-addressing table, load factor <= 0.5 (hash_table.cpp layout)
    size = 1
    while size < 2 * max(len(sorted_keys), 1):
        size *= 2
    tkeys = np.zeros(size, np.uint32)
    tvals = np.zeros(size, np.int32)
    tvals.fill(np.iinfo(np.int32).min)
    keys_c = sorted_keys.astype(np.uint32)
    vals_c = np.ascontiguousarray(values.astype(np.int32))
    lib.sctag_hash_build(
        keys_c.ctypes.data, vals_c.ctypes.data, len(sorted_keys), size,
        tkeys.ctypes.data, tvals.ctypes.data,
    )
    # raw bytes + offsets: zero-copy from a SeqBuffer, one join otherwise
    buf = getattr(segments, "buf", None)
    if buf is not None:
        offs = segments.offs
    else:
        lens = np.fromiter(
            (len(s) for s in segments), np.int64, count=n
        ) if n else np.zeros(0, np.int64)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        joined = "".join(segments).encode("latin-1")
        buf = np.frombuffer(joined, np.uint8)
    offs = np.ascontiguousarray(offs, np.int64)
    counts = np.zeros(n, np.int64)
    single = np.zeros(n, np.int64)
    lib.sctag_probe_rows(
        buf.ctypes.data, offs.ctypes.data, n,
        tkeys.ctypes.data, tvals.ctypes.data, size, k, HOST_PROBE_THREADS,
        counts.ctypes.data, single.ctypes.data,
    )
    return counts, single


def host_dict_fallback(segments, words_fwd, words_rc):
    """Generic Aho-Corasick-equivalent for non-uniform/non-ACGT whitelists.

    Same per-segment (count, single value) contract as probe_segments, but
    supports arbitrary equal-or-mixed-length patterns via per-length window
    dict probes. Slow host path; only exercised on exotic inputs.
    """
    table: dict[str, int] = {}
    for i, w in enumerate(words_fwd):
        table[w] = i
    for i, w in enumerate(words_rc):
        table[w] = -i
    lens = sorted({len(w) for w in table})
    n = len(segments)
    counts = np.zeros(n, dtype=np.int64)
    single_val = np.zeros(n, dtype=np.int64)
    for r, seg in enumerate(segments):
        hits = []
        for e in range(len(seg)):
            for k in lens:
                if e + 1 >= k:
                    w = seg[e - k + 1 : e + 1]
                    if w in table:
                        hits.append(table[w])
        counts[r] = len(hits)
        if len(hits) == 1:
            single_val[r] = hits[0]
    return counts, single_val
