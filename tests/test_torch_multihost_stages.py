"""Multi-host stages of the port (twin of test_multihost_stages.py): N
cooperating `python -m sctagger_tpu_torch` processes on the fs transport
(CPU) write output byte-identical to the single-host port run and to
`sctagger_tpu` on the same seeded inputs, for all four stages at 2 and 3
hosts; plus the in-process HostGroup collectives, rows with > 4 fields and
the proof that the BAM shard scans overlap."""

import json
import subprocess
import threading
import time

import numpy as np
import pytest

from bamgen import write_bam
from mhharness import (
    gz_bytes,
    port_cmd,
    port_env,
    run_port,
    run_port_hosts,
    write_fixture,
)
from oracle import random_dna
from sctagger_tpu.cli import main as jax_main


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded fixture and the single-host outputs of both packages:
    stage 1 (gz TSV), match_trie on it, the alt stage on it, and
    extract_sr_bc on a two-contig BAM."""
    tmp = tmp_path_factory.mktemp("tmh")
    fq, wl, sr = write_fixture(tmp, seed=99, n_reads=120, n_bcs=30)
    rng = np.random.default_rng(55)
    pool = [random_dna(rng, 16) for _ in range(50)]
    alns = {c: [] for c in ("c1", "c2")}
    for i in range(6000):
        c = "c1" if i % 2 == 0 else "c2"
        flag = int(rng.choice([0, 16, 272], p=[0.5, 0.4, 0.1]))
        alns[c].append({"flag": flag, "name": f"q{i}", "pos": i,
                        "tags": [["CB", pool[int(rng.integers(50))] + "-1"]],
                        "seq": random_dna(rng, 20)})
    bam = tmp / "mh.bam"
    write_bam(str(bam), ["c1", "c2"], alns)

    lr = tmp / "lr.tsv.gz"
    argv = {
        "extract_lr_bc": ["extract_lr_bc", "-r", str(fq)],
        "match_trie": ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2",
                       "-t", "1"],
        "extract_sr_bc_from_lr": ["extract_sr_bc_from_lr", "-i", str(lr), "-wl",
                                  str(wl)],
        "extract_sr_bc": ["extract_sr_bc", "-i", str(bam)],
    }
    outs = {"extract_lr_bc": ".tsv.gz", "match_trie": ".tsv",
            "extract_sr_bc_from_lr": ".tsv.gz", "extract_sr_bc": ".tsv.gz"}
    want = {}
    for stage, a in argv.items():
        ext = outs[stage]
        port_out = lr if stage == "extract_lr_bc" else tmp / f"{stage}_port{ext}"
        run_port([*a, "-o", port_out])
        jax_out = tmp / f"{stage}_jax{ext}"
        jax_main([*a, "-o", str(jax_out)])
        read = gz_bytes if ext == ".tsv.gz" else (lambda p: p.read_bytes())
        want[stage] = read(port_out)
        assert want[stage] == read(jax_out), f"{stage}: port != sctagger_tpu"
        assert want[stage].count(b"\n") > 5, stage
    return {"argv": argv, "outs": outs, "want": want, "wl": wl, "tmp": tmp}


def _read(path):
    return gz_bytes(path) if str(path).endswith(".gz") else path.read_bytes()


@pytest.mark.parametrize("n_hosts", [2, 3])
@pytest.mark.parametrize("stage", ["extract_lr_bc", "match_trie",
                                   "extract_sr_bc_from_lr", "extract_sr_bc"])
def test_stage_multihost_fs(inputs, tmp_path, stage, n_hosts):
    out = tmp_path / f"multi{inputs['outs'][stage]}"
    run_port_hosts([*inputs["argv"][stage], "-o", out], n_hosts)
    assert _read(out) == inputs["want"][stage]
    assert not list(tmp_path.glob("*.part"))  # the merge cleaned up


def test_hostgroup_fs_collectives(tmp_path):
    """In-process fs-transport reductions: int64 sum/min/max, the int64
    min/max identities and values past 32 bits, allgather order, barrier."""
    from sctagger_tpu_torch.parallel.multihost import HostGroup

    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    results = {}

    def worker(h):
        g = HostGroup(h, 3, tmp_path / "sync")
        assert g.transport == "fs"
        a = np.arange(5, dtype=np.int64) + h * 10
        results[h, "sum"] = g.allreduce(a, "sum")
        results[h, "min"] = g.allreduce(a, "min")
        results[h, "max"] = g.allreduce(a, "max")
        results[h, "ident"] = (
            g.allreduce(np.array([imax if h else 1 << 40], np.int64), "min"),
            g.allreduce(np.array([imin if h != 2 else -(1 << 41)], np.int64), "max"),
        )
        results[h, "gather"] = g.allgather_scalar(h + 7)
        g.barrier()

    ts = [threading.Thread(target=worker, args=(h,)) for h in range(3)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    base = np.arange(5, dtype=np.int64)
    for h in range(3):
        assert np.array_equal(results[h, "sum"], base * 3 + 30)
        assert np.array_equal(results[h, "min"], base)
        assert np.array_equal(results[h, "max"], base + 20)
        mn, mx = results[h, "ident"]
        assert mn.dtype == mx.dtype == np.int64
        assert mn.tolist() == [1 << 40] and mx.tolist() == [-(1 << 41)]
        assert np.array_equal(results[h, "gather"], [7, 8, 9])


def test_extract_sr_bc_from_lr_multihost_extra_fields(inputs, tmp_path):
    """Rows with > 4 tab fields parse tolerantly at any host count: 2 hosts
    == the single-host port == sctagger_tpu."""
    rng = np.random.default_rng(7)
    bcs = inputs["wl"].read_text().splitlines()
    rows = []
    for i in range(60):
        bc = bcs[int(rng.integers(len(bcs)))]
        seg = random_dna(rng, 4) + bc + random_dna(rng, 4)
        extra = "\textra\tfield" if i % 3 == 0 else ""
        loc = "NA" if i % 11 == 0 else str(int(rng.integers(0, 50)))
        rows.append(f"r{i}\t1\t{loc}\t{seg}{extra}\n")
    lr = tmp_path / "extra.tsv"
    lr.write_text("".join(rows))
    argv = ["extract_sr_bc_from_lr", "-i", str(lr), "-wl", str(inputs["wl"])]
    single, jax_out, multi = (tmp_path / f"{t}.tsv.gz" for t in ("s", "j", "m"))
    run_port([*argv, "-o", single])
    jax_main([*argv, "-o", str(jax_out)])
    run_port_hosts([*argv, "-o", multi], 2)
    assert gz_bytes(multi) == gz_bytes(single) == gz_bytes(jax_out)
    assert gz_bytes(single)


def test_extract_sr_bc_multihost_scans_overlap(tmp_path):
    """The BAM shard scans run concurrently: host 1, launched ALONE,
    publishes its scan window (scanwin.h1, written right after its scan and
    before the spill reconcile) while host 0 has not started. Then host 0
    runs and the merged output equals the single-host port run and
    sctagger_tpu's."""
    rng = np.random.default_rng(56)
    pool = [random_dna(rng, 16) for _ in range(80)]
    alns = {"c1": [
        {"flag": 0, "name": f"q{i}", "pos": i,
         "tags": [["CB", pool[int(rng.integers(80))] + "-1"]],
         "seq": random_dna(rng, 150)}
        for i in range(20000)
    ]}
    bam = str(tmp_path / "big_overlap.bam")
    write_bam(bam, ["c1"], alns)
    single = tmp_path / "single.tsv.gz"
    run_port(["extract_sr_bc", "-i", bam, "-o", single])
    jax_out = tmp_path / "jax.tsv.gz"
    jax_main(["extract_sr_bc", "-i", bam, "-o", str(jax_out)])

    out = tmp_path / "sr_overlap.tsv.gz"
    argv = ["extract_sr_bc", "-i", bam, "-o", out, "--n-hosts", "2"]
    p1 = subprocess.Popen(port_cmd(*argv, "--host-id", "1"), env=port_env(),
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    p0 = None
    try:
        deadline = time.monotonic() + 120
        blob = None
        while time.monotonic() < deadline:
            hits = list(tmp_path.glob("sr_overlap.tsv.gz.sync-*/scanwin.h1.blob"))
            if hits:
                blob = hits[0]
                break
            if p1.poll() is not None:
                break
            time.sleep(0.05)
        assert blob is not None, (
            "host 1 never published its scan window while running alone: "
            + (p1.communicate(timeout=30)[1] or "")[-2000:]
        )
        win = json.loads(blob.read_bytes())
        assert win[1] >= win[0]
        p0 = subprocess.Popen(port_cmd(*argv, "--host-id", "0"), env=port_env(),
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                              text=True)
        errs = [p.communicate(timeout=240)[1] for p in (p0, p1)]
        assert [p0.returncode, p1.returncode] == [0, 0], "\n".join(errs)[-3000:]
    finally:
        for p in (p0, p1):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    assert gz_bytes(out) == gz_bytes(single) == gz_bytes(jax_out)


def test_multihost_turns_checkpointing_off(inputs, tmp_path):
    """SCTAG_CHECKPOINT_DIR is ignored on every multi-host branch (shard-
    dependent batches would collide on one job key): no part is written and
    the output is the single-host one."""
    ckpt = tmp_path / "ckpt"
    for stage in ("extract_lr_bc", "match_trie", "extract_sr_bc_from_lr",
                  "extract_sr_bc"):
        out = tmp_path / f"{stage}{inputs['outs'][stage]}"
        run_port_hosts([*inputs["argv"][stage], "-o", out], 2,
                       SCTAG_CHECKPOINT_DIR=str(ckpt))
        assert _read(out) == inputs["want"][stage], stage
    assert not ckpt.exists() or not list(ckpt.rglob("part*"))
    # single-host runs under the same variable do write parts (the control)
    run_port([*inputs["argv"]["match_trie"], "-o", tmp_path / "ck.tsv"],
             SCTAG_CHECKPOINT_DIR=str(ckpt))
    assert list(ckpt.rglob("part*"))
