"""Shared helpers of the port's multi-host tests: port CLI processes on the
CPU (one per host), their environment, a free TCP port for gloo, and the
seeded stage-1 fixture (FASTQ with planted adapters, whitelist, SR TSV)."""

from __future__ import annotations

import gzip
import os
import socket
import subprocess
import sys

from oracle import mutate, random_dna

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAPTER = "CTACACGACGCTCTTCCGATCT"
TIMEOUT = 240  # seconds per process: a hung rendezvous fails its own test


def port_env(**extra) -> dict:
    """The port CLI on the CPU, one device, no checkpointing; a lost peer
    fails a sync within 180 s."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["SCTAG_DEVICE"] = "cpu"
    env["SCTAG_SYNC_TIMEOUT"] = "180"
    for k in ("SCTAG_CHECKPOINT_DIR", "SCTAG_VIRTUAL_DEVICES", "SCTAG_MAX_DEVICES",
              "SCTAG_MODEL_PARALLEL"):
        env.pop(k, None)
    env.update(extra)
    return env


def port_cmd(*argv) -> list[str]:
    return [sys.executable, "-m", "sctagger_tpu_torch", *map(str, argv)]


def run_port(argv, **env):
    """One port CLI process; asserts it succeeds."""
    proc = subprocess.run(port_cmd(*argv), env=port_env(**env), capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def run_port_hosts(argv, n_hosts: int, extra_argv=(), **env) -> None:
    """One port CLI process per host, all at once; asserts all succeed."""
    procs = [
        subprocess.Popen(
            port_cmd(*argv, "--n-hosts", n_hosts, "--host-id", h, *extra_argv),
            env=port_env(**env), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True,
        )
        for h in range(n_hosts)
    ]
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * n_hosts, "\n".join(errs)[-4000:]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gz_bytes(path) -> bytes:
    return gzip.open(path, "rb").read()


def write_fixture(tmp, seed: int, n_reads: int, n_bcs: int):
    """FASTQ of reads with a mutated adapter + barcode planted on either
    strand (or none), a whitelist and an SR TSV of the barcodes. Returns
    (fastq, whitelist, sr_tsv) paths."""
    import numpy as np

    from sctagger_tpu_torch.core.packing import rev_compl

    rng = np.random.default_rng(seed)
    bcs = [random_dna(rng, 16) for _ in range(n_bcs)]
    lines = []
    for i in range(n_reads):
        bc = mutate(rng, bcs[int(rng.integers(len(bcs)))], int(rng.integers(0, 3)))
        body = random_dna(rng, int(rng.integers(60, 200)))
        r = rng.random()
        if r < 0.45:
            pos = int(rng.integers(3, 20))
            ad = mutate(rng, ADAPTER, int(rng.integers(0, 3)))
            seq = body[:pos] + ad + bc + body[pos:]
        elif r < 0.8:
            cut = max(0, len(body) - int(rng.integers(3, 20)))
            seq = body[:cut] + rev_compl(ADAPTER + bc) + body[cut:]
        else:
            seq = body
        lines.append(f"@r{i} c\n{seq}\n+\n{'I' * len(seq)}\n")
    fq = tmp / "reads.fastq"
    fq.write_text("".join(lines))
    wl = tmp / "whitelist.txt"
    wl.write_text("".join(b + "\n" for b in bcs))
    sr = tmp / "sr.tsv"
    sr.write_text("".join(f"{b}\t{1000 - j}\n" for j, b in enumerate(bcs)))
    return fq, wl, sr
