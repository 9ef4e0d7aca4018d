"""Multi-host stages of the port over the gloo transport (twin of
test_multihost_jax.py): N real processes rendezvous through a local TCP
address (`--coordinator`), HostGroup picks the ``gloo`` transport, and the
outputs equal the single-host port run and `sctagger_tpu`'s byte for byte.
The sync dir holds no fs-reduction file (red*.npy, bar*) after the run: the
reductions rode torch.distributed."""

import subprocess
import sys
import textwrap

import pytest

from mhharness import free_port, gz_bytes, port_env, run_port, run_port_hosts, write_fixture
from sctagger_tpu.cli import main as jax_main


def _run_gloo(argv, n_hosts, sync_dir) -> None:
    run_port_hosts(argv, n_hosts, ("--coordinator", f"127.0.0.1:{free_port()}",
                                   "--sync-dir", str(sync_dir)))


def _assert_gloo_transport(sync_dir) -> None:
    """The fs transport drops redNNNNN*.npy / barNNNNN files per collective;
    a gloo run leaves none (the part merge and blobs may still use files)."""
    leftovers = [p.name for p in sync_dir.glob("*")
                 if p.name.startswith(("red", "bar")) or p.name.endswith(".npy")]
    assert leftovers == [], leftovers


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tgloo")
    fq, wl, sr = write_fixture(tmp, seed=17, n_reads=90, n_bcs=25)
    lr = tmp / "lr.tsv.gz"
    argv = {
        "extract_lr_bc": ["extract_lr_bc", "-r", str(fq)],
        "match_trie": ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2",
                       "-t", "1"],
        "extract_sr_bc_from_lr": ["extract_sr_bc_from_lr", "-i", str(lr), "-wl",
                                  str(wl)],
    }
    ext = {"extract_lr_bc": ".tsv.gz", "match_trie": ".tsv",
           "extract_sr_bc_from_lr": ".tsv.gz"}
    want = {}
    for stage, a in argv.items():
        port_out = lr if stage == "extract_lr_bc" else tmp / f"{stage}_port{ext[stage]}"
        jax_out = tmp / f"{stage}_jax{ext[stage]}"
        run_port([*a, "-o", port_out])
        jax_main([*a, "-o", str(jax_out)])
        read = gz_bytes if ext[stage] == ".tsv.gz" else (lambda p: p.read_bytes())
        want[stage] = read(port_out)
        assert want[stage] == read(jax_out), f"{stage}: port != sctagger_tpu"
        assert want[stage].count(b"\n") > 2, stage
    return argv, ext, want


def test_gloo_transport_collectives_multiprocess(tmp_path):
    """HostGroup over gloo across 2 real processes: int64 sum/min/max with
    values past 32 bits and the int64 min/max identities, allgather order,
    barrier, a float sum; both ranks get the same results, and nothing rides
    the sync dir."""
    script = textwrap.dedent(
        """
        import sys
        pid, n, port, sync = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
        import numpy as np
        from sctagger_tpu_torch.parallel.multihost import (
            HostGroup, close_gloo, gloo_processes_match, init_gloo)
        assert not gloo_processes_match(n)
        init_gloo(f"127.0.0.1:{port}", pid, n)
        assert gloo_processes_match(n)
        g = HostGroup(pid, n, sync)  # transport auto-detects 'gloo'
        assert g.transport == "gloo", g.transport
        imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
        s = g.allreduce(np.array([1 << 40, -(1 << 41), 7], np.int64) + pid, "sum")
        mn = g.allreduce(np.array([pid + 5, (1 << 50) + pid, imax if pid else 3],
                                  np.int64), "min")
        mx = g.allreduce(np.array([pid, -pid, imin if pid else -(1 << 45)],
                                  np.int64), "max")
        assert s.dtype == mn.dtype == mx.dtype == np.int64
        ga = g.allgather_scalar(100 + pid)
        g.barrier()
        f = g.allreduce(np.array([0.5, -2.0]) * (pid + 1), "sum")
        close_gloo()
        print("RES", s.tolist(), mn.tolist(), mx.tolist(), ga.tolist(),
              f.tolist(), flush=True)
        """
    )
    port = free_port()
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(h), "2", str(port),
                          str(tmp_path / "sync")],
                         env=port_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for h in range(2)
    ]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [o.strip().splitlines()[-1] for o, _ in outs]
    want = (
        "RES "
        f"{[(1 << 41) + 1, -(1 << 42) + 1, 15]} "
        f"{[5, 1 << 50, 3]} {[1, 0, -(1 << 45)]} {[100, 101]} {[1.5, -6.0]}"
    )
    assert lines == [want, want], lines
    assert not (tmp_path / "sync").exists() or not list((tmp_path / "sync").glob("*"))


@pytest.mark.parametrize("stage", ["extract_lr_bc", "match_trie",
                                   "extract_sr_bc_from_lr"])
def test_stage_multihost_gloo(inputs, tmp_path, stage):
    """The stage over 2 gloo processes == single-host, byte for byte
    (stage 1 includes the cross-host location-histogram SUM and the int64
    MIN/MAX of its bounds; the alt stage the count SUM and first-occurrence
    MIN)."""
    argv, ext, want = inputs
    out = tmp_path / f"multi{ext[stage]}"
    sync = tmp_path / "sync"
    _run_gloo([*argv[stage], "-o", out], 2, sync)
    got = gz_bytes(out) if ext[stage] == ".tsv.gz" else out.read_bytes()
    assert got == want[stage]
    _assert_gloo_transport(sync)
