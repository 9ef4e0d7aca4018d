"""The stage-1 adapter-scan kernel (csrc/adapter_scan.cu): wrapper, plain
version, host packing and unpack.

Port of sctagger_tpu/ops/adapter_pallas.py (K6, ``_adapter_scan_call``).
Layout of one chunk:

  text   (B, row_bytes) uint8, 2-bit packed and row-major as
         ``SeqBuffer.encode_packed`` emits it (char j of a row at byte j >> 2,
         bits 2 * (j & 3)); row_bytes a multiple of 16
  lens   (B,) int32 read lengths
  peq    (2, 4) int32 from ``prep_peq``: [strand][A, C, G, T]
  out    (12, B) int32: rows [d, cnt, s0..s3] of the adapter, then of its
         reverse complement (see csrc/adapter_scan.cu); slots at or past
         min(cnt, SLOTS_K) are -1 and cnt is not clipped

A wrapper given CPU tensors runs the plain version (``adapter_scan_ref``);
given CUDA tensors it launches the kernel on the current stream or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from sctagger_tpu.core.packing import STRICT_TABLE, encode_rows

from .myers import MAX_PATTERN_LEN, _step

SLOTS_K = 4
N_OUT = 2 * (2 + SLOTS_K)
ROW_CHARS = 64  # row padding unit: one 16-byte load of packed text

LAUNCHES = 0  # kernel launches by adapter_scan


def prep_peq(peq2: np.ndarray) -> np.ndarray:
    """(5, 2) int32 Peq of (adapter, reverse complement), as the JAX
    package's ``build_peq_multi`` returns it -> (2, 4) int32 kernel input
    (the pad-code row 4 has no 2-bit code and is dropped)."""
    peq2 = np.asarray(peq2)
    if peq2.shape != (5, 2):
        raise ValueError(f"peq2 must be (5, 2), got {peq2.shape}")
    return np.ascontiguousarray(peq2[:4].T.astype(np.int32))


def row_bytes(lens):
    """Packed row size in bytes for reads of length ``lens`` (an int or an
    array): whole 16-byte loads of 64 chars, at least one."""
    return (np.maximum(lens, 1) + ROW_CHARS - 1) // ROW_CHARS * (ROW_CHARS // 4)


def pack_chunk(seqs, idx: np.ndarray, lmax: int):
    """Encode + 2-bit pack reads ``idx`` of ``seqs`` (none longer than
    ``lmax``) into one chunk.

    Returns (text (B, row_bytes) uint8, lens int32, junk bool). ``junk``
    marks reads with in-sequence non-ACGT chars, which 2 bits cannot hold
    (they would read as 'A'): the caller routes them to the mask fallback.
    SeqBuffer inputs pack natively; anything else goes through
    ``encode_rows`` and numpy."""
    pad_to = 4 * int(row_bytes(lmax))
    enc_packed = getattr(seqs, "encode_packed", None)
    if enc_packed is not None:
        return enc_packed(idx, pad_to=pad_to, table=STRICT_TABLE)
    codes, lens = encode_rows(seqs, idx, pad_to=pad_to)
    junk = ((codes == 4) & (np.arange(pad_to)[None, :] < lens[:, None])).any(axis=1)
    cp = codes & 3
    text = cp[:, 0::4] | (cp[:, 1::4] << 2) | (cp[:, 2::4] << 4) | (cp[:, 3::4] << 6)
    return np.ascontiguousarray(text, dtype=np.uint8), lens.astype(np.int32), junk


def unpack_scan_out(out: np.ndarray, B: int):
    """(12, >= B) kernel rows -> (fwd, rc) dicts of (B,) ``d``, (B,) ``cnt``
    and (B, SLOTS_K) ``slots`` (the JAX ``unpack_scan_out``'s surface)."""
    out = np.asarray(out)[:, :B]

    def strand(base: int) -> dict:
        return {
            "d": out[base],
            "cnt": out[base + 1],
            "slots": out[base + 2 : base + 2 + SLOTS_K].T,
        }

    return strand(0), strand(2 + SLOTS_K)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def adapter_scan_ref(
    text: torch.Tensor, lens: torch.Tensor, peq, m: int
) -> torch.Tensor:
    """Plain torch version of the kernel (any device): a loop over text
    positions, vectorised over reads and both strands, on myers._step."""
    dev = text.device
    B = text.shape[0]
    tab = torch.from_numpy(np.asarray(peq, np.int32)).to(dev).T  # (4, 2)
    lens = lens.to(dev).long()
    pv = torch.full((B, 2), -1, dtype=torch.int32, device=dev)
    mv = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    score = torch.full((B, 2), m, dtype=torch.int32, device=dev)
    d = score.clone()
    cnt = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    slots = torch.full((B, 2, SLOTS_K), -1, dtype=torch.int32, device=dev)
    k = torch.arange(SLOTS_K, device=dev)
    for j in range(int(lens.max()) if B else 0):
        code = (text[:, j >> 2] >> (2 * (j & 3))) & 3
        pv, mv, score = _step(pv, mv, score, tab[code.long()], m)
        valid = (lens > j)[:, None]
        improve = valid & (score < d)
        d = torch.where(improve, score, d)
        cnt = torch.where(improve, 0, cnt)
        slots = torch.where(improve[..., None], -1, slots)
        tie = valid & (score == d)
        slots = torch.where(tie[..., None] & (k == cnt[..., None]), j, slots)
        cnt = cnt + tie.int()
    rows = [
        torch.cat([d[:, p, None], cnt[:, p, None], slots[:, p]], dim=1).T
        for p in range(2)
    ]
    return torch.cat(rows, dim=0).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _launch(text: torch.Tensor, lens: torch.Tensor, peq, m: int) -> torch.Tensor:
    global LAUNCHES
    from . import _build

    dev = text.device
    if text.dtype != torch.uint8 or text.dim() != 2 or not text.is_contiguous():
        raise ValueError(f"text must be contiguous 2-d uint8, got {text.dtype} "
                         f"{tuple(text.shape)}")
    if lens.device != dev or lens.dtype != torch.int32 or lens.dim() != 1 \
            or not lens.is_contiguous():
        raise ValueError(f"lens must be contiguous 1-d int32 on {dev}")
    B, rb = text.shape
    if lens.numel() != B:
        raise ValueError(f"lens has {lens.numel()} entries for {B} reads")
    if B == 0:
        raise ValueError("text has no reads")
    if rb == 0 or rb % 16 or text.data_ptr() % 16:
        raise ValueError("text rows must be a nonzero multiple of 16 bytes, "
                         "16-byte aligned")
    if not 1 <= m <= MAX_PATTERN_LEN:
        raise ValueError(f"pattern length {m} outside 1..{MAX_PATTERN_LEN}")
    peq_host = np.ascontiguousarray(peq, dtype=np.int32)
    if peq_host.shape != (2, 4):
        raise ValueError(f"peq must be (2, 4), got {peq_host.shape}")

    out = torch.empty((N_OUT, B), dtype=torch.int32, device=dev)
    lib = _build.load("adapter_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sctag_adapter_scan(
            text.data_ptr(), B, rb, lens.data_ptr(),
            peq_host.ctypes.data, m, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"sctag_adapter_scan launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def adapter_scan(text: torch.Tensor, lens: torch.Tensor, peq, m: int) -> torch.Tensor:
    """Adapter scan of one chunk (K6): (12, B) int32 rows. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if text.device.type == "cpu":
        return adapter_scan_ref(text, lens, peq, m)
    if text.device.type == "cuda":
        return _launch(text, lens, peq, m)
    raise ValueError(f"no adapter-scan kernel for device {text.device}")
