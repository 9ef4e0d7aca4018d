"""Multi-host stage execution (port of sctagger_tpu/parallel/multihost.py):
shard inputs per host, reduce globals, merge output parts.

The same stages run on N hosts with byte-identical final output. Each host
processes a contiguous shard of the global record range (io/sharding.py
keeps global record ids equal to the single-stream order), and the few
cross-host quantities (the stage-1 adapter-location histogram, the alt
stage's whitelist count and first-occurrence vectors) are all-reduced
through one of two transports:

* ``gloo`` -- torch.distributed collectives (all_reduce with SUM, MIN or MAX
              on a CPU tensor). Chosen automatically when a process group
              is initialized with one rank per host (the CLI's
              ``--coordinator``, ``init_gloo`` below).
* ``fs``   -- shared-filesystem exchange: atomic .npy drops + polling
              barrier. The fallback when no process group is initialized.

Blobs and the output part merge always ride the shared filesystem, on
either transport.

Determinism makes the fs transport safe to resume: every exchanged artifact
is a pure function of the inputs, so a leftover file from a crashed run with
the same inputs is byte-identical to what this run would write. The sync
directory is namespaced by a content key of (stage, inputs, params) so runs
with different inputs never collide.

HostGroup (fs transport, blobs, part merge) and make_host_group are the JAX
package's; the gloo transport replaces its jax one.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import time

import numpy as np

_POLL_S = 0.05


def _timeout_s() -> float:
    return float(os.environ.get("SCTAG_SYNC_TIMEOUT", "600"))


_NP_REDUCE = {"sum": np.add, "min": np.minimum, "max": np.maximum}


def gloo_processes_match(n_hosts: int) -> bool:
    """True iff a torch.distributed process group is initialized with one
    rank per host."""
    if n_hosts <= 1:
        return False
    import torch.distributed as dist

    return (
        dist.is_available()
        and dist.is_initialized()
        and dist.get_world_size() == n_hosts
    )


def init_gloo(coordinator: str, host_id: int, n_hosts: int) -> None:
    """Join the gloo process group of ``n_hosts`` ranks rendezvousing at
    ``coordinator`` (host:port; rank 0 listens there), then run one barrier
    at once: every rank is aligned right after the rendezvous, while the
    first real collective comes after per-host work of uneven length."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        rank=host_id,
        world_size=n_hosts,
        timeout=datetime.timedelta(seconds=_timeout_s()),
    )
    HostGroup(host_id, n_hosts, sync_dir="", transport="gloo").barrier()


def close_gloo() -> None:
    """Destroy the process group, if one is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class HostGroup:
    """Fixed group of N hosts executing one stage cooperatively.

    Collective calls must be issued in the same order on every host (tags are
    derived from a per-group sequence counter, like MPI communicators).
    """

    def __init__(
        self,
        host_id: int,
        n_hosts: int,
        sync_dir: str | os.PathLike,
        transport: str | None = None,
    ):
        assert 0 <= host_id < n_hosts, (host_id, n_hosts)
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.sync_dir = pathlib.Path(sync_dir)
        if transport is None:
            transport = "gloo" if gloo_processes_match(n_hosts) else "fs"
        assert transport in ("gloo", "fs"), transport
        self.transport = transport
        self._seq = 0
        if n_hosts > 1 and transport == "fs":
            self.sync_dir.mkdir(parents=True, exist_ok=True)

    # ---- collectives -------------------------------------------------------

    def allreduce(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        """Elementwise all-reduce of one ndarray across hosts."""
        assert op in _NP_REDUCE, op
        if self.n_hosts == 1:
            return np.asarray(arr)
        self._seq += 1
        if self.transport == "gloo":
            return self._gloo_allreduce(np.asarray(arr), op)
        return self._fs_allreduce(np.asarray(arr), op, f"red{self._seq:05d}{op}")

    def allgather_scalar(self, value: int) -> np.ndarray:
        """Gather one int64 per host, ordered by host id."""
        one_hot = np.zeros(self.n_hosts, np.int64)
        one_hot[self.host_id] = int(value)
        return self.allreduce(one_hot, "sum")

    def barrier(self) -> None:
        if self.n_hosts == 1:
            return
        self._seq += 1
        if self.transport == "gloo":
            self._gloo_allreduce(np.zeros(1, np.int32), "sum")
            return
        tag = f"bar{self._seq:05d}"
        self._touch(self.sync_dir / f"{tag}.h{self.host_id}")
        for h in range(self.n_hosts):
            self._wait_for(self.sync_dir / f"{tag}.h{h}")

    # ---- fs transport ------------------------------------------------------

    @staticmethod
    def _touch(path: pathlib.Path) -> None:
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_bytes(b"")
        os.replace(tmp, path)

    @staticmethod
    def _wait_for(path: pathlib.Path) -> None:
        deadline = time.monotonic() + _timeout_s()
        while not path.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"multihost sync timeout waiting for {path}")
            time.sleep(_POLL_S)

    def _fs_allreduce(self, arr: np.ndarray, op: str, tag: str) -> np.ndarray:
        mine = self.sync_dir / f"{tag}.h{self.host_id}.npy"
        # np.save appends '.npy' when missing — give the tmp name the suffix
        tmp = mine.with_name(f"tmp{os.getpid()}." + mine.name)
        np.save(tmp, arr)
        os.replace(tmp, mine)
        out = None
        for h in range(self.n_hosts):
            p = self.sync_dir / f"{tag}.h{h}.npy"
            self._wait_for(p)
            part = np.load(p)
            out = part if out is None else _NP_REDUCE[op](out, part)
        return out

    # ---- gloo transport ----------------------------------------------------

    @staticmethod
    def _gloo_allreduce(arr: np.ndarray, op: str) -> np.ndarray:
        """all_reduce of a CPU tensor holding ``arr`` in its own dtype: int64
        counts and the int64 min/max identities stay 64-bit."""
        import torch
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).copy())
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, op=red)
        return t.numpy().reshape(arr.shape)

    # ---- point-to-point byte blobs (shared FS, any transport) -----------
    # Small metadata handoffs (e.g. the BAM shard spill chain and the
    # variable-size stage-2 gather) always ride the sync dir: the output
    # part merge already requires a shared FS, and blob sizes are tiny
    # relative to the stage inputs.

    def put_bytes(self, tag: str, data: bytes) -> None:
        self.sync_dir.mkdir(parents=True, exist_ok=True)
        path = self.sync_dir / f"{tag}.blob"
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_bytes(data)
        os.replace(tmp, path)

    def get_bytes(self, tag: str) -> bytes:
        path = self.sync_dir / f"{tag}.blob"
        self._wait_for(path)
        return path.read_bytes()

    def gather_bytes(self, tag: str, data: bytes) -> list[bytes] | None:
        """Gather one blob per host; host 0 returns them ordered by host id,
        other hosts return None."""
        self.put_bytes(f"{tag}.h{self.host_id}", data)
        if self.host_id != 0:
            return None
        return [self.get_bytes(f"{tag}.h{h}") for h in range(self.n_hosts)]

    # ---- output part merge ---------------------------------------------

    def part_path(self, outfile: str, host_id: int | None = None) -> str:
        h = self.host_id if host_id is None else host_id
        return f"{outfile}.h{h:04d}of{self.n_hosts}.part"

    def write_part_and_merge(self, outfile: str, text: str, open_out_fn) -> None:
        """Write this host's rendered rows; host 0 merges all parts into the
        final output through ``open_out_fn(outfile)`` (byte-identical to the
        single-host stream since shards are contiguous global-rid ranges)."""
        if self.n_hosts == 1:
            out = open_out_fn(outfile)
            out.write(text)
            self._close(out)
            return
        part = pathlib.Path(self.part_path(outfile))
        tmp = part.with_name(part.name + f".tmp{os.getpid()}")
        tmp.write_text(text)
        os.replace(tmp, part)
        self.barrier()  # all parts on disk
        if self.host_id == 0:
            out = open_out_fn(outfile)
            for h in range(self.n_hosts):
                p = pathlib.Path(self.part_path(outfile, h))
                out.write(p.read_text())
            self._close(out)
            for h in range(self.n_hosts):
                pathlib.Path(self.part_path(outfile, h)).unlink(missing_ok=True)

    @staticmethod
    def _close(out) -> None:
        import sys

        if out is not sys.stdout:
            out.close()


def make_host_group(args, stage: str, inputs: list[str], params: dict) -> HostGroup:
    """Build a HostGroup from the additive CLI flags (--host-id/--n-hosts).

    The sync dir is namespaced by a content key so different jobs sharing an
    outfile path never cross-talk; identical re-runs safely reuse leftovers
    (all exchanged artifacts are deterministic)."""
    n_hosts = getattr(args, "n_hosts", 1) or 1
    host_id = getattr(args, "host_id", 0) or 0
    if n_hosts > 1:
        assert args.outfile, "--n-hosts > 1 requires -o/--outfile (no stdout merge)"
    sync_dir = getattr(args, "sync_dir", None)
    if sync_dir is None:
        from ..pipeline.checkpoint import job_key

        key = job_key(stage, inputs, {**params, "n_hosts": n_hosts})
        base = args.outfile if args.outfile else stage
        sync_dir = f"{base}.sync-{key[:16]}"
    return HostGroup(host_id, n_hosts, sync_dir)
