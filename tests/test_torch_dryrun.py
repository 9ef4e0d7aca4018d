"""The port's multi-device dry run (sctagger_tpu_torch.entry
.dryrun_multichip; twin of __graft_entry__.dryrun_multichip) on the CPU,
the CPU device repeated by SCTAG_VIRTUAL_DEVICES: the three stages through
the CLI byte-identical at 1 and 4 devices and at model-parallel 2, the grid
kernels equal to one device, and the mid-stage drop recovered."""

import os
import pathlib

import pytest
import torch

from sctagger_tpu_torch import entry as tentry
from sctagger_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("SCTAG_DEVICE", "cpu")
    for k in ("SCTAG_CHECKPOINT_DIR", "SCTAG_MAX_DEVICES", "SCTAG_MODEL_PARALLEL"):
        monkeypatch.delenv(k, raising=False)


def test_dryrun_multichip_4(monkeypatch):
    monkeypatch.setenv("SCTAG_VIRTUAL_DEVICES", "4")
    res = tentry.dryrun_multichip(4)
    assert res["devices"] == 4 and res["model_parallel"] == 2
    assert res["sharded_calls"] > 0 and res["alt_sharded_calls"] > 0
    assert res["recomputed"] == res["batches"] - 2
    assert res["match_rows"] > 50
    # the knobs it set are restored
    assert os.environ["SCTAG_VIRTUAL_DEVICES"] == "4"
    assert "SCTAG_MAX_DEVICES" not in os.environ


def test_dryrun_sets_virtual_devices_when_unset(monkeypatch):
    """With one visible device and SCTAG_VIRTUAL_DEVICES unset, the dry run
    repeats the device itself; with too few virtual devices it raises."""
    monkeypatch.delenv("SCTAG_VIRTUAL_DEVICES", raising=False)
    pm.STATS.update(sharded_calls=0, devices=0)
    res = tentry.dryrun_multichip(2)
    assert res["devices"] == 2 and pm.STATS["devices"] == 2
    assert "SCTAG_VIRTUAL_DEVICES" not in os.environ
    monkeypatch.setenv("SCTAG_VIRTUAL_DEVICES", "2")
    with pytest.raises(RuntimeError, match="need 4 devices"):
        tentry.dryrun_multichip(4)


def test_fixture_equals_the_jax_dry_run_fixture(tmp_path):
    """The port's dry-run inputs are the JAX dry run's, byte for byte."""
    import __graft_entry__ as jentry

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = jentry._write_fixture(tmp_path / "j")
    got = tentry._write_fixture(tmp_path / "t")
    for w, g in zip(want, got):
        assert pathlib.Path(g).read_bytes() == pathlib.Path(w).read_bytes()
