"""``match_trie -lr <segments.tsv.gz> -sr <whitelist.tsv.gz> -mr <mr> -o
<matches.tsv.gz>``, the SR route's last stage (Snakefile rule match_trie).

Check, against the plain reference (reference.match):
- every row of the output: rows in read order, one a read; its segment is
  the read's, its tie count is the number of barcodes it lists, and each
  listed barcode lies at the stated distance (``claims_wrong``);
- a sample of reads drawn from the seed (``check_sample``), with every read
  the output gives more ties than the kernel rows hold: each read's row, or
  its absence, byte for byte, so every tie and the least distance
  (``rows_wrong``);
- every invocation's output equals the last one's (``outputs_differ``)."""

from __future__ import annotations

import re

import numpy as np

from .. import seqs
from ..reference import edit
from ..reference import match as ref
from . import common

UNIT = "segments"
TIES_IN_ROW = 8  # a row with more ties goes through the escalation path


def _segments_tsv(data, rows) -> bytes:
    n = rows.size
    return seqs.join_rows([
        (data["names"][rows], np.full(n, 36)),
        seqs.int_field(data["dist"][rows]),
        seqs.int_field(data["loc"][rows]),
        seqs.text_field(data["seg"][rows], data["seg_lens"][rows]),
    ])


def write_inputs(data, config, params, workdir) -> dict:
    n = data["names"].shape[0]
    bcs = data["barcodes"]
    sr = workdir / "sr_bc.tsv.gz"
    seqs.write_gz(sr, seqs.join_rows([
        seqs.text_field(bcs, np.full(bcs.shape[0], bcs.shape[1])),
        seqs.int_field(data["sr_counts"]),
    ]))
    lr = workdir / "lr_bc.tsv.gz"
    seqs.write_gz(lr, _segments_tsv(data, np.arange(n)))
    warm = workdir / "lr_bc.warm.tsv.gz"
    seqs.write_gz(warm, _segments_tsv(data, np.arange(min(n, int(params["warm_rows"])))))
    return {"lr": lr, "lr_warm": warm, "sr": sr}


def argv(files, config, out, warm: bool) -> list[str]:
    return ["match_trie", "-lr", str(files["lr_warm" if warm else "lr"]),
            "-sr", str(files["sr"]), "-mr", str(config["max_error"]),
            "-bl", str(config["barcode_length"]), "-o", str(out)]


def units(data) -> int:
    return int(data["names"].shape[0])


def summary(data, config) -> dict:
    return {"mean_segment_len": float(data["seg_lens"].mean()),
            "patterns": 2 * int(data["barcodes"].shape[0]),
            "barcode_length": int(config["barcode_length"])}


def _expected_line(data, i, got, bc_fwd, bc_rc) -> bytes | None:
    if got is None:
        return None
    dist, ties = got
    names = data["names"][i].tobytes()
    seg = seqs.decode_rows(data["seg"][i:i + 1], data["seg_lens"][i:i + 1])[0]
    bcs = b",".join(bc_fwd[p >> 1] if p & 1 else bc_rc[p >> 1] for p in ties.tolist())
    return b"\t".join([names, str(dist).encode(), str(ties.size).encode(), seg, bcs])


def _int(b: bytes) -> int:
    return int(b) if b.isdigit() else -1


def _claims_wrong(data, text: bytes, device) -> int:
    """Rows of the output whose claims do not hold (see the module note)."""
    import torch

    rows = [ln.split(b"\t") for ln in common.lines(text)]
    if not rows:
        return 0
    bad = np.array([len(r) != 5 or not (r[1].isdigit() and r[2].isdigit()) for r in rows])
    rows = [[b"", b"-1", b"0", b"", b""] if k else r for r, k in zip(rows, bad)]
    names = data["names"].view("S36").ravel()
    order = np.argsort(names)
    got = np.array([r[0] for r in rows], dtype="S36")
    at = np.minimum(np.searchsorted(names[order], got), names.size - 1)
    rid = order[at]
    bad |= names[rid] != got
    bad[1:] |= rid[1:] <= rid[:-1]  # read order, one row a read
    seg_txt = np.where(data["seg"] < 4, seqs.ASCII[np.minimum(data["seg"], 3)], 0)
    segs = seg_txt.view(f"S{seg_txt.shape[1]}").ravel()
    bad |= segs[rid] != np.array([r[3] for r in rows], dtype=segs.dtype)
    e = np.array([_int(r[1]) for r in rows])
    lists = [r[4].split(b",") if r[4] else [] for r in rows]
    bad |= np.array([_int(r[2]) for r in rows]) != np.array([len(x) for x in lists])
    bcs = data["barcodes"]
    w = np.full(bcs.shape[0], bcs.shape[1])
    pid = {b: 2 * i + 1 for i, b in enumerate(seqs.decode_rows(bcs, w))}
    pid.update({b: 2 * i for i, b in enumerate(seqs.decode_rows(3 - bcs[:, ::-1], w))})
    pr, pp = [], []
    for i, x in enumerate(lists):
        for b in x:
            pr.append(i)
            pp.append(pid.get(b, -1))
    pr, pp = np.array(pr, np.int64), np.array(pp, np.int64)
    unknown = pp < 0
    bad[pr[unknown]] = True
    pr, pp = pr[~unknown], pp[~unknown]
    pats = torch.from_numpy(ref.patterns(bcs).astype(np.int16)).to(device)
    dist = np.zeros(pr.size, np.int64)
    for s in range(0, pr.size, 1 << 18):
        r, p = rid[pr[s:s + (1 << 18)]], pp[s:s + (1 << 18)]
        texts = torch.from_numpy(data["seg"][r].astype(np.int16)).to(device)
        lens = torch.from_numpy(data["seg_lens"][r]).to(device)
        best = torch.full((r.size,), 99, dtype=torch.int16, device=device)
        for j, col in edit.dp_columns(pats[torch.from_numpy(p).to(device)], texts,
                                      pairwise=True):
            best = torch.where(j < lens, torch.minimum(best, col), best)
        dist[s:s + r.size] = best.cpu().numpy()
    bad[pr[dist != e[pr]]] = True
    return int(bad.sum())


def check(data, config, params, outputs, device, seed, control=None):
    """(verdict, info). With ``control="band"`` the rows judged are not the
    output's but those of the reference at max_error - 1 (a sweep cut to
    the prefilter's band)."""
    text = common.read_text(outputs[-1]) if outputs else b""
    rows = {ln[:36]: ln for ln in common.lines(text)}
    n = units(data)
    sample = common.sample_rows(n, int(params["check_sample"]), seed)
    many = re.findall(rb"^([^\t\n]+)\t\d+\t(\d+)\t", text, flags=re.M)
    many = {nm for nm, k in many if int(k) > TIES_IN_ROW}
    if many:
        allnames = data["names"].view("S36").ravel()
        extra = np.flatnonzero(np.isin(allnames, np.array(sorted(many), dtype="S36")))
        sample = np.union1d(sample, extra[: int(params["check_sample"])])
    mr = int(config["max_error"])
    args = (data["barcodes"], data["seg"], data["seg_lens"], sample)
    got = ref.match_reads(*args, mr, device)
    bcs = data["barcodes"]
    bc_fwd = seqs.decode_rows(bcs, np.full(bcs.shape[0], bcs.shape[1]))
    bc_rc = seqs.decode_rows(3 - bcs[:, ::-1], np.full(bcs.shape[0], bcs.shape[1]))
    if control == "band":
        ctl = ref.match_reads(*args, mr - 1, device)
        observed = [_expected_line(data, i, c, bc_fwd, bc_rc) for i, c in zip(sample.tolist(), ctl)]
        differ = claims = 0
    elif control is None:
        observed = [rows.get(data["names"][i].tobytes()) for i in sample.tolist()]
        differ = common.outputs_differ(outputs, text) if outputs else 1
        claims = _claims_wrong(data, text, device)
    else:
        raise ValueError(f"unknown control {control!r}")
    wrong = sum(_expected_line(data, i, g, bc_fwd, bc_rc) != o
                for i, g, o in zip(sample.tolist(), got, observed))
    return common.verdict(rows_wrong=(wrong, 0), claims_wrong=(claims, 0),
                          outputs_differ=(differ, 0)), {
        "sampled": int(sample.size), "many_tie_rows": len(many)}
