"""The stage-1 adapter-scan kernels (csrc/adapter_scan.cu): wrappers, plain
versions, host packing and unpack.

Port of sctagger_tpu/ops/adapter_pallas.py (K6, ``_adapter_scan_call``), in
two entry points over one Myers sweep:

SLOTS (``adapter_scan``), one chunk of 2-bit text:
  text   (B, row_bytes) uint8, 2-bit packed and row-major as
         ``SeqBuffer.encode_packed`` emits it (char j of a row at byte j >> 2,
         bits 2 * (j & 3)); row_bytes a multiple of 16
  lens   (B,) int32 read lengths
  peq    (2, 4) int32 from ``prep_peq``: [strand][A, C, G, T]
  out    (12, B) int32: rows [d, cnt, s0..s3] of the adapter, then of its
         reverse complement (see csrc/adapter_scan.cu); slots at or past
         min(cnt, SLOTS_K) are -1 and cnt is not clipped
The kernel cuts each read into ``nseg`` segments (``segment_bounds``), scans
each from a warm-up 2m chars before it and merges them in order;
``adapter_scan_segments_ref`` and ``merge_segment_rows`` are the plain
versions of that cut and merge.

MASK (``adapter_mask``), the reads SLOTS cannot decide (non-ACGT chars, more
than SLOTS_K ends), m <= 32:
  codes  (B, L) uint8 byte codes (4 = pad/junk, matches nothing), L % 32 == 0
  lens   (B,) int32
  out    d (2, B) int32, the min score per strand over j < len, clamped to
         m; bits (B, 2, L // 32) int32, bit j & 31 of word j >> 5 set where
         j < len and the score is d (``mask_ends`` reads them back)
The kernel cuts each read into ``nseg`` segments of whole mask words and
scans each strand of each once (a thread each), keeping a running (min,
positions at the min); ``adapter_mask_segments_ref`` is the plain version
of that cut, scan and merge.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel on the current stream or raises. ``LAUNCHES`` and
``MASK_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.packing import STRICT_TABLE, encode_rows
from .myers import MAX_PATTERN_LEN, _step, scores_scan, scores_scan_mw

SLOTS_K = 4
N_OUT = 2 * (2 + SLOTS_K)
ROW_CHARS = 64  # row padding unit: one 16-byte load of packed text
SEG_CHARS = 64  # segment length unit of SLOTS (one 16-byte load)
MASK_WORD = 32  # positions per mask word (MASK's row length unit)
MAX_NSEG = 32  # segments per read, at most (one warp)
TARGET_THREADS = 1 << 16  # SLOTS threads that fill the card: ~16 warps per SM
#                           (measured best: 4 segments at 16,384 reads, 1 at
#                           131,072; PERF.md section 5)
MIN_SEG = 256  # SLOTS segment chars, at least: the warm-up (2m <= 64 chars)
#                stays a small part of a segment
MASK_MAX_NSEG = 32  # MASK segments per read, at most (one warp)
MASK_TARGET_THREADS = 1 << 16  # MASK threads that fill the card
MASK_MIN_SEG = MASK_WORD  # MASK segment chars, at least: few reads take short
#                           segments, so the chain of warm-up + segment steps
#                           that sets a small launch's time is short

LAUNCHES = 0  # kernel launches by adapter_scan (SLOTS)
MASK_LAUNCHES = 0  # kernel launches by adapter_mask (MASK)


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




def segment_bounds(lens: torch.Tensor, nseg: int, m: int, unit: int = SEG_CHARS):
    """The kernels' cut of each read into ``nseg`` segments of a multiple of
    ``unit`` chars (SEG_CHARS for SLOTS, MASK_WORD for MASK): (lo, hi, w0),
    each (B, nseg) int64. Segment k covers [lo, hi) (empty when lo >= hi);
    its warm-up starts at w0 <= lo - 2m, a multiple of 16, where a fresh
    Myers state gives exact scores from lo on."""
    lens = lens.long()
    seg = (lens + nseg - 1) // nseg
    seg = (seg + unit - 1) // unit * unit
    lo = torch.arange(nseg, device=lens.device)[None, :] * seg[:, None]
    hi = torch.minimum(lo + seg[:, None], lens[:, None])
    w0 = torch.clamp((lo - 2 * m) // 16 * 16, min=0)
    return lo, hi, w0


def adapter_scan_segments_ref(
    text: torch.Tensor, lens: torch.Tensor, peq, m: int, nseg: int
) -> torch.Tensor:
    """Plain version of the kernel's per-segment rows: (B, nseg, 2, 6) int32
    [d, cnt, s0..s3] of each segment and strand. Each segment scans from its
    warm-up, whose scores only lower the running min it starts from (U);
    positions are global."""
    dev = text.device
    B = text.shape[0]
    tab = torch.from_numpy(np.asarray(peq, np.int32)).to(dev).T  # (4, 2)
    lo, hi, w0 = (t.reshape(-1) for t in segment_bounds(lens.to(dev), nseg, m))
    rid = torch.arange(B, device=dev).repeat_interleave(nseg)
    n = rid.numel()
    pv = torch.full((n, 2), -1, dtype=torch.int32, device=dev)
    mv = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    score = torch.full((n, 2), m, dtype=torch.int32, device=dev)
    d = score.clone()
    cnt = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    slots = torch.full((n, 2, SLOTS_K), -1, dtype=torch.int32, device=dev)
    k = torch.arange(SLOTS_K, device=dev)
    live = lo < hi
    steps = int((hi - w0)[live].max()) if bool(live.any()) else 0
    last_byte = text.shape[1] - 1
    for t in range(steps):
        pos = w0 + t
        valid = (live & (pos < hi))[:, None]
        byte = text[rid, torch.clamp(pos >> 2, max=last_byte)].long()
        code = (byte >> (2 * (pos & 3))) & 3
        npv, nmv, nscore = _step(pv, mv, score, tab[code], m)
        pv = torch.where(valid, npv, pv)
        mv = torch.where(valid, nmv, mv)
        score = torch.where(valid, nscore, score)
        warm = valid & (pos < lo)[:, None]
        d = torch.where(warm, torch.minimum(d, score), d)
        inseg = valid & (pos >= lo)[:, None]
        improve = inseg & (score < d)
        d = torch.where(improve, score, d)
        cnt = torch.where(improve, 0, cnt)
        slots = torch.where(improve[..., None], -1, slots)
        tie = inseg & (score == d)
        slots = torch.where(tie[..., None] & (k == cnt[..., None]), pos[:, None, None].int(),
                            slots)
        cnt = cnt + tie.int()
    rows = torch.cat([d[..., None], cnt[..., None], slots], dim=2)
    return rows.reshape(B, nseg, 2, 2 + SLOTS_K)


def merge_segment_rows(seg_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's in-order merge: (B, nseg, 2, 6) segment
    rows -> (12, B) read rows. The min wins; at a common min the counts add
    and the first SLOTS_K ends are kept in position order."""
    acc = seg_rows[:, 0].clone()  # (B, 2, 6)
    k = torch.arange(SLOTS_K, device=seg_rows.device)
    for s in range(1, seg_rows.shape[1]):
        b = seg_rows[:, s]
        d, c, sl = acc[..., 0], acc[..., 1], acc[..., 2:]
        take = b[..., 0] < d
        tie = b[..., 0] == d
        src = torch.clamp(k - c[..., None], 0, SLOTS_K - 1)
        cat = torch.where(k < c[..., None], sl, torch.gather(b[..., 2:], 2, src))
        merged = torch.cat([d[..., None], (c + b[..., 1])[..., None], cat], dim=2)
        acc = torch.where(take[..., None], b, torch.where(tie[..., None], merged, acc))
    return acc.permute(1, 2, 0).reshape(N_OUT, -1).contiguous()


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """(L, B, 2) bool, L % 32 == 0 -> (B, 2, L // 32) int32: bit j & 31 of
    word j >> 5 is mask[j]."""
    L, B, _ = mask.shape
    w = mask.permute(1, 2, 0).reshape(B, 2, L // MASK_WORD, MASK_WORD).long()
    words = (w << torch.arange(MASK_WORD, device=mask.device)).sum(dim=3)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def mask_ends(bits: np.ndarray) -> np.ndarray:
    """One strand's (W,) int32 mask words -> the positions whose bit is
    set, ascending, int64."""
    return np.flatnonzero(
        np.unpackbits(np.ascontiguousarray(bits, "<i4").view(np.uint8), bitorder="little")
    ).astype(np.int64)


def hw_block(text_T, peq2, lengths, m: int):
    """The JAX mask path's _hw_block: (L, B) codes + (5, 2) or (W, 5, 2) Peq
    -> per-read dists (B, 2), the min over valid positions clamped to m, and
    argmin masks (L, B, 2) over valid positions only."""
    scan = scores_scan if peq2.dim() == 2 else scores_scan_mw
    scores = scan(text_T, peq2, m, shw=False)  # (L, B, 2)
    L = text_T.shape[0]
    pos = torch.arange(L, device=scores.device)[:, None]
    pos_valid = (pos < lengths[None, :])[:, :, None]
    masked = torch.where(pos_valid, scores, 1 << 20)
    d = masked.amin(dim=0).clamp(max=m)  # (B, 2); empty reads clamp to m
    return d, masked == d[None]


def adapter_mask_ref(codes: torch.Tensor, lens: torch.Tensor, peq, m: int):
    """Plain version of MASK (any device): ``hw_block`` and a bit pack.
    Returns (d (2, B) int32, bits (B, 2, L // 32) int32)."""
    dev = codes.device
    peq5 = torch.zeros((5, 2), dtype=torch.int32, device=dev)
    peq5[:4] = torch.from_numpy(np.asarray(peq, np.int32)).to(dev).T
    d, mask = hw_block(codes.T, peq5, lens.to(dev).long(), m)
    return d.T.contiguous().to(torch.int32), pack_mask_bits(mask)


def adapter_mask_segments_ref(codes: torch.Tensor, lens: torch.Tensor, peq, m: int,
                              nseg: int):
    """Plain version of MASK's one-pass segmented scan (any device): the
    same (d (2, B) int32, bits (B, 2, L // 32) int32) as ``adapter_mask_ref``,
    computed as the kernel does. Each of a read's ``nseg`` segments
    (``segment_bounds`` in whole words) steps its warm-up, then keeps per
    strand a running min d, the bits of the current word at d and cur, the
    word of d's last drop, and stores each finished word. The merge takes
    the read's min D over its segments and zeroes, per segment, the words
    before cur where d == D, and all its words where d > D."""
    dev = codes.device
    B, L = codes.shape
    W = L // MASK_WORD
    tab = torch.zeros((5, 2), dtype=torch.int32, device=dev)  # code 4+: no match
    tab[:4] = torch.from_numpy(np.asarray(peq, np.int32)).to(dev).T
    lens = torch.clamp(lens.to(dev).long(), max=L)
    lo, hi, w0 = (t.reshape(-1) for t in segment_bounds(lens, nseg, m, unit=MASK_WORD))
    rid = torch.arange(B, device=dev).repeat_interleave(nseg)
    n = rid.numel()
    pv = torch.full((n, 2), -1, dtype=torch.int32, device=dev)
    mv = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    score = torch.full((n, 2), m, dtype=torch.int32, device=dev)
    d = score.clone()
    w = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    cur = (lo >> 5)[:, None].repeat(1, 2)
    out = torch.zeros((B, 2, W), dtype=torch.int64, device=dev)
    live = lo < hi
    steps = int((hi - w0)[live].max()) if bool(live.any()) else 0
    for t in range(steps):
        pos = w0 + t
        valid = live & (pos < hi)
        code = torch.clamp(codes[rid, torch.clamp(pos, max=L - 1)].long(), max=4)
        npv, nmv, nscore = _step(pv, mv, score, tab[code], m)
        pv = torch.where(valid[:, None], npv, pv)
        mv = torch.where(valid[:, None], nmv, mv)
        score = torch.where(valid[:, None], nscore, score)
        inseg = (valid & (pos >= lo))[:, None]
        word = (pos >> 5)[:, None]
        drop = inseg & (score < d)
        d = torch.where(drop, score, d)
        w = torch.where(drop, 0, w)
        cur = torch.where(drop, word, cur)
        w = w | torch.where(inseg & (score == d), 1 << (pos & 31)[:, None], 0)
        flush = inseg[:, 0] & (((pos & 31) == 31) | (pos == hi - 1))  # a word ends
        i = flush.nonzero(as_tuple=True)[0]
        out[rid[i], :, word[i, 0]] = w[i]
        w = torch.where(flush[:, None], 0, w)
    big_d = d.reshape(B, nseg, 2).amin(dim=1)  # (B, 2); empty reads: m
    end = torch.where(d == big_d[rid], cur, ((hi + 31) >> 5)[:, None])
    wi = torch.arange(W, device=dev)
    zero = (live[:, None, None] & (wi >= (lo >> 5)[:, None, None])
            & (wi < end[:, :, None]))  # (n, 2, W)
    out = torch.where(zero.reshape(B, nseg, 2, W).any(dim=1), 0, out)
    bits = torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
    return big_d.T.contiguous().to(torch.int32), bits


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def nseg_for(b: int, row_bytes: int) -> int:
    """Segments per read for a SLOTS launch of ``b`` reads of rows of
    ``row_bytes``: the fewest (a power of two) whose threads fill the card,
    with segments of at least MIN_SEG chars."""
    nseg = 1
    while (nseg < MAX_NSEG and b * nseg < TARGET_THREADS
           and 4 * row_bytes // (2 * nseg) >= MIN_SEG):
        nseg *= 2
    return nseg


def mask_nseg_for(b: int, row_len: int) -> int:
    """Segments per read for a MASK launch of ``b`` reads of rows of
    ``row_len`` chars: the fewest (a power of two) whose threads (one per
    read, strand and segment) fill the card, with segments of at least
    MASK_MIN_SEG chars."""
    nseg = 1
    while (nseg < MASK_MAX_NSEG and 2 * b * nseg < MASK_TARGET_THREADS
           and row_len // (2 * nseg) >= MASK_MIN_SEG):
        nseg *= 2
    return nseg


def _check_nseg(nseg: int, most: int) -> int:
    if nseg not in [1 << i for i in range(most.bit_length())]:
        raise ValueError(f"nseg must be a power of two <= {most}, got {nseg}")
    return nseg.bit_length() - 1


def _check_launch(text, lens, peq, m, what: str):
    dev = text.device
    if text.dtype != torch.uint8 or text.dim() != 2 or not text.is_contiguous():
        raise ValueError(f"{what} must be contiguous 2-d uint8, got {text.dtype} "
                         f"{tuple(text.shape)}")
    if lens.device != dev or lens.dtype != torch.int32 or lens.dim() != 1 \
            or not lens.is_contiguous():
        raise ValueError(f"lens must be contiguous 1-d int32 on {dev}")
    if lens.numel() != text.shape[0]:
        raise ValueError(f"lens has {lens.numel()} entries for {text.shape[0]} reads")
    if text.shape[0] == 0:
        raise ValueError(f"{what} has no reads")
    if not 1 <= m <= MAX_PATTERN_LEN:
        raise ValueError(f"pattern length {m} outside 1..{MAX_PATTERN_LEN}")
    peq_host = np.ascontiguousarray(peq, dtype=np.int32)
    if peq_host.shape != (2, 4):
        raise ValueError(f"peq must be (2, 4), got {peq_host.shape}")
    return peq_host


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def adapter_scan(text: torch.Tensor, lens: torch.Tensor, peq, m: int,
                 nseg: int | None = None) -> torch.Tensor:
    """Adapter scan of one chunk (K6, SLOTS): (12, B) int32 rows. CPU tensors
    take the plain version; CUDA tensors launch the kernel with ``nseg_for``
    segments per read. ``nseg`` overrides that count; it is a test hook, so
    that a check on the card can cover the segment merge at 1 and 32."""
    global LAUNCHES
    if text.device.type == "cpu":
        return adapter_scan_ref(text, lens, peq, m)
    if text.device.type != "cuda":
        raise ValueError(f"no adapter-scan kernel for device {text.device}")
    peq_host = _check_launch(text, lens, peq, m, "text")
    B, rb = text.shape
    if rb == 0 or rb % 16 or text.data_ptr() % 16:
        raise ValueError("text rows must be a nonzero multiple of 16 bytes, "
                         "16-byte aligned")
    log_nseg = _check_nseg(nseg_for(B, rb) if nseg is None else nseg, MAX_NSEG)
    from . import _build

    out = torch.empty((N_OUT, B), dtype=torch.int32, device=text.device)
    lib = _build.load("adapter_scan")
    with torch.cuda.device(text.device):
        err = lib.sctag_adapter_scan(
            text.data_ptr(), B, rb, lens.data_ptr(), peq_host.ctypes.data, m,
            log_nseg, out.data_ptr(), _stream(text.device),
        )
    if err != 0:
        raise RuntimeError(f"sctag_adapter_scan launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def adapter_mask(codes: torch.Tensor, lens: torch.Tensor, peq, m: int,
                 nseg: int | None = None):
    """Exact argmin mask of the reads SLOTS cannot decide (K6, MASK): (d
    (2, B) int32, bits (B, 2, L // 32) int32). CPU tensors take the plain
    version; CUDA tensors launch the kernel with ``mask_nseg_for`` segments
    per read. ``nseg`` overrides that count; it is a test hook, so that a
    check on the card can cover every segment count."""
    global MASK_LAUNCHES
    if codes.device.type == "cpu":
        return adapter_mask_ref(codes, lens, peq, m)
    if codes.device.type != "cuda":
        raise ValueError(f"no adapter-mask kernel for device {codes.device}")
    peq_host = _check_launch(codes, lens, peq, m, "codes")
    B, L = codes.shape
    if L == 0 or L % MASK_WORD or codes.data_ptr() % 16:
        raise ValueError(f"codes rows must be a nonzero multiple of {MASK_WORD} "
                         "bytes, 16-byte aligned")
    log_nseg = _check_nseg(mask_nseg_for(B, L) if nseg is None else nseg, MASK_MAX_NSEG)
    from . import _build

    d = torch.empty((2, B), dtype=torch.int32, device=codes.device)
    bits = torch.empty((B, 2, L // MASK_WORD), dtype=torch.int32, device=codes.device)
    lib = _build.load("adapter_scan")
    with torch.cuda.device(codes.device):
        err = lib.sctag_adapter_mask(
            codes.data_ptr(), B, L, lens.data_ptr(), peq_host.ctypes.data, m,
            log_nseg, d.data_ptr(), bits.data_ptr(), _stream(codes.device),
        )
    if err != 0:
        raise RuntimeError(f"sctag_adapter_mask launch failed: cudaError {err}")
    MASK_LAUNCHES += 1
    return d, bits
