"""`match_trie` on ONT long-read segments: the port's cli.main on the CPU
against the benchmark's plain reference (gpubench/reference/match.py, plain
torch), every row.

The traffic is the sr25k.match.ont cell's window model
(gpubench/traffic/ont_segments.py) at a small size, its cut derived anew at
each edit rate: segments cut as extract_lr_bc's filter_aln cuts them,
ragged, from both strands. A center barcode's two-substitution neighbours
join the whitelist and segments holding the center are planted, so that
reads tie with more than 8 patterns at distance 2 and the escalation runs.
Several slices of the streaming layout run, so the prefilter's distance-1
tier and the ragged sweep (K2's plain version) both take reads; the stage's
SCTAG_STATS record counts them."""

import functools
import itertools
import json

import numpy as np
import pytest
import torch

from gpubench import manifest, seqs
from gpubench.reference import match as ref
from gpubench.stages import common
from gpubench.stages import match_trie as stage
from gpubench.traffic import ont_segments
from sctagger_tpu_torch.cli import main as torch_main
from sctagger_tpu_torch.models import matcher

torch.set_num_threads(1)

SPEC = manifest.cell("sr25k.match.ont")
N_SEGMENTS, N_BARCODES, N_PLANTED = 3000, 300, 12


@functools.lru_cache(maxsize=None)
def _cut(rate: float) -> tuple:
    params = {**SPEC["workload"]["params"], "edits": {"rate": rate, "weights": [1, 1, 1]}}
    return tuple(map(tuple, ont_segments.derive_cut(20_000, 7, params, SPEC["config_data"],
                                                    torch.device("cpu"))))


def _traffic(rate: float, rc_share: float, seed: int):
    config = {**SPEC["config_data"], "whitelist_barcodes": N_BARCODES - N_PLANTED,
              "segments_per_invocation": N_SEGMENTS - N_PLANTED}
    params = {**SPEC["workload"]["params"], "rc_share": rc_share,
              "edits": {"rate": rate, "weights": [1, 1, 1]},
              "assumed": {"cut": {"shares": [list(r) for r in _cut(rate)]}},
              "warm_rows": 200}
    d = ont_segments.generate(params, config, seed)
    rng = np.random.default_rng(seed)
    bl = config["barcode_length"]
    center = seqs.random_codes(rng, (1, bl))
    planted = np.repeat(center, N_PLANTED, axis=0)
    # distinct pairs of inner positions (a change at an end can align with
    # a flank base), each changed to another base
    pairs = list(itertools.combinations(range(3, bl - 3), 2))
    for i, k in enumerate(rng.choice(len(pairs), size=N_PLANTED, replace=False)):
        at = list(pairs[k])
        planted[i, at] = (planted[i, at] + rng.integers(1, 4, size=2)) & 3
    bcs = np.concatenate([d["barcodes"], planted])
    assert np.unique(seqs.codes_to_keys(bcs)).size == N_BARCODES
    rows = np.concatenate([seqs.random_codes(rng, (N_PLANTED, 3)),
                           np.repeat(center, N_PLANTED, axis=0),
                           seqs.random_codes(rng, (N_PLANTED, 3))], axis=1)
    lens = np.full(N_PLANTED, rows.shape[1])
    rows[1::2] = seqs.revcomp_rows(rows[1::2], lens[1::2])
    w = max(d["seg"].shape[1], rows.shape[1])
    seg = np.full((N_SEGMENTS, w), seqs.PAD, np.uint8)
    seg[: -N_PLANTED, : d["seg"].shape[1]] = d["seg"]
    seg[-N_PLANTED:, : rows.shape[1]] = rows
    data = {
        "names": seqs.uuid_names(rng, N_SEGMENTS),
        "seg": seg,
        "seg_lens": np.concatenate([d["seg_lens"], lens]),
        "dist": np.concatenate([d["dist"], np.full(N_PLANTED, 2)]),
        "loc": np.concatenate([d["loc"], np.full(N_PLANTED, 19)]),
        "barcodes": bcs,
        "sr_counts": np.concatenate([d["sr_counts"], np.full(N_PLANTED, 50)]),
    }
    return data, config, params


def _expected(data, max_error: int) -> bytes:
    """Every row the reference matches, in read order: name, distance, tie
    count, segment, the tie barcodes (a reverse-complement tie printed as
    such) by ascending pattern id."""
    bcs = data["barcodes"]
    width = np.full(bcs.shape[0], bcs.shape[1])
    fwd = seqs.decode_rows(bcs, width)
    rc = seqs.decode_rows(3 - bcs[:, ::-1], width)
    n = data["seg_lens"].size
    got = ref.match_reads(bcs, data["seg"], data["seg_lens"], np.arange(n), max_error,
                          torch.device("cpu"))
    segs = seqs.decode_rows(data["seg"], data["seg_lens"])
    out = []
    for i, g in enumerate(got):
        if g is None:
            continue
        dist, ties = g
        names = b",".join(fwd[p >> 1] if p & 1 else rc[p >> 1] for p in ties.tolist())
        out.append(b"\t".join([data["names"][i].tobytes(), str(dist).encode(),
                               str(ties.size).encode(), segs[i], names]))
    return b"".join(ln + b"\n" for ln in out)


@pytest.mark.parametrize("rc_share", [0.0, 0.5])
@pytest.mark.parametrize("rate", [0.05, 0.10])
def test_ont_segments_match_the_reference(tmp_path, monkeypatch, rate, rc_share):
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    monkeypatch.setenv("SCTAG_PROGRESS", "0")
    monkeypatch.setenv("SCTAG_STATS", str(tmp_path / "stats.jsonl"))
    monkeypatch.delenv("SCTAG_PROFILE", raising=False)
    monkeypatch.delenv("SCTAG_CHECKPOINT_DIR", raising=False)
    # several slices of the streaming layout: the distance-1 tier probes
    monkeypatch.setattr(matcher, "PASS1_CHUNK", 1024)
    data, config, params = _traffic(rate, rc_share, seed=int(rate * 1000 + rc_share * 10))
    files = stage.write_inputs(data, config, params, tmp_path)
    out = tmp_path / "out.tsv.gz"
    torch_main(stage.argv(files, config, out, warm=False))

    got = common.read_text(out)
    want = _expected(data, config["max_error"])
    assert got.count(b"\n") == want.count(b"\n") > N_SEGMENTS // 4
    assert got == want

    (rec,) = [json.loads(ln) for ln in (tmp_path / "stats.jsonl").read_text().splitlines()]
    c = rec["counters"]
    for k in ("device_chunks_ragged", "prefilter_d1_resolved", "prefilter_d1_indel",
              "escalated_reads"):
        assert c[k] > 0, (k, c)
    assert c["device_chunks_ragged"] <= c["device_chunks"]
    assert c["prefilter_d1_indel"] <= c["prefilter_d1_resolved"] <= c["prefilter_resolved"]
    assert 0 < c["sweep_pad_cells"] < c["sweep_cells"]
    assert (data["loc"] < 0).any() == (rc_share > 0)
    many = [ln for ln in want.splitlines() if int(ln.split(b"\t")[2]) > matcher.TIES_K]
    assert many
