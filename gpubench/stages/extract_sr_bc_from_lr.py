"""``extract_sr_bc_from_lr -i <lr_bc.tsv.gz> -wl <whitelist.txt.gz> -o
<sr_bc_from_lr.tsv.gz>``, the LR-only route's whitelist stage (Snakefile
rule extract_sr_bc_from_lr).

Check: the whole output, row by row, against reference.alt; every
invocation's output equals the last one's."""

from __future__ import annotations

import numpy as np

from .. import seqs
from ..reference import alt as ref
from . import common

UNIT = "rows"


def _rows_tsv(data, rows) -> bytes:
    n = rows.size
    na = data["is_na"][rows]
    d_txt = seqs.int_field(np.where(na, -1, data["dist"][rows]))
    l_txt = seqs.int_field(data["loc"][rows])
    w = max(2, l_txt[0].shape[1])
    loc = np.zeros((n, w), np.uint8)
    loc[:, :l_txt[0].shape[1]] = l_txt[0]
    loc[na, :2] = np.frombuffer(b"NA", np.uint8)
    return seqs.join_rows([
        (data["names"][rows], np.full(n, 36)),
        d_txt,
        (loc, np.where(na, 2, l_txt[1])),
        seqs.text_field(data["seg"][rows], data["seg_lens"][rows]),
    ])


def _whitelist_txt(keys, k) -> bytes:
    out = np.empty((keys.size, k + 1), np.uint8)
    out[:, :k] = seqs.keys_to_ascii(keys, k)
    out[:, k] = ord("\n")
    return out.tobytes()


def write_inputs(data, config, params, workdir) -> dict:
    k = int(config["barcode_length"])
    n = data["names"].shape[0]
    wl = workdir / "whitelist.txt.gz"
    seqs.write_gz(wl, _whitelist_txt(data["whitelist"], k))
    wl_warm = workdir / "whitelist.warm.txt.gz"
    seqs.write_gz(wl_warm, _whitelist_txt(data["whitelist"][: int(params["warm_whitelist"])], k))
    lr = workdir / "lr_bc.tsv.gz"
    seqs.write_gz(lr, _rows_tsv(data, np.arange(n)))
    warm = workdir / "lr_bc.warm.tsv.gz"
    seqs.write_gz(warm, _rows_tsv(data, np.arange(min(n, int(params["warm_rows"])))))
    return {"lr": lr, "lr_warm": warm, "wl": wl, "wl_warm": wl_warm}


def argv(files, config, out, warm: bool) -> list[str]:
    w = "_warm" if warm else ""
    return ["extract_sr_bc_from_lr", "-i", str(files["lr" + w]),
            "-wl", str(files["wl" + w]), "-o", str(out),
            "--max-barcode-cnt", str(config["max_barcode_cnt"]),
            "--step-size", str(config["step_size"]), "--thresh", str(config["thresh"])]


def units(data) -> int:
    return int(data["names"].shape[0])


def summary(data, config) -> dict:
    return {"whitelist": int(data["whitelist"].size)}


def check(data, config, params, outputs, device, seed, control=None):
    """(verdict, info). With ``control="forward"`` the rows judged are the
    reference's with the reverse-complement words left out."""
    k = int(config["barcode_length"])
    args = (data["whitelist"], data["seg"], data["seg_lens"], data["is_na"], k,
            int(config["max_barcode_cnt"]), int(config["step_size"]), float(config["thresh"]),
            device)
    txt = seqs.keys_to_ascii(data["whitelist"], k)

    def render(kept):
        return [txt[b].tobytes() + b"\t" + str(c).encode() for b, c in kept]

    expected = render(ref.expected_rows(*args))
    if control == "forward":
        observed = render(ref.expected_rows(*args, forward_only=True))
        differ = 0
    elif control is None:
        text = common.read_text(outputs[-1]) if outputs else b""
        observed = common.lines(text)
        differ = common.outputs_differ(outputs, text) if outputs else 1
    else:
        raise ValueError(f"unknown control {control!r}")
    return common.verdict(rows_wrong=(common.rows_wrong(expected, observed), 0),
                          outputs_differ=(differ, 0)), {"rows": len(expected)}
