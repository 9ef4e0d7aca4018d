"""A host of the port drops mid-stage and is relaunched (twin of
test_multihost_failure.py): the surviving host keeps waiting at the merge
barrier, and the final output equals the single-host port run and
`sctagger_tpu`'s byte for byte. Recovery needs only the failed host's
work."""

import subprocess
import sys
import textwrap

import numpy as np

from mhharness import TIMEOUT, port_cmd, port_env, run_port
from oracle import mutate, random_dna
from sctagger_tpu.cli import main as jax_main


def test_match_trie_host_drop_and_relaunch(tmp_path):
    rng = np.random.default_rng(23)
    bcs = sorted({random_dna(rng, 16) for _ in range(25)})
    sr = tmp_path / "sr.tsv"
    sr.write_text("".join(f"{b}\t7\n" for b in bcs))
    rows = []
    for i in range(80):
        seg = random_dna(rng, 22)
        if rng.random() < 0.75:
            bc = mutate(rng, bcs[int(rng.integers(len(bcs)))], int(rng.integers(0, 3)))
            seg = seg[:3] + bc + seg[3:6]
        rows.append(f"r{i}\t0\t3\t{seg}\n")
    lr = tmp_path / "lr.tsv"
    lr.write_text("".join(rows))
    base = ["match_trie", "-lr", str(lr), "-sr", str(sr), "-mr", "2", "-t", "1"]

    single = tmp_path / "single.tsv"
    run_port([*base, "-o", single])
    jax_out = tmp_path / "jax.tsv"
    jax_main([*base, "-o", str(jax_out)])

    multi = tmp_path / "multi.tsv"
    argv = [*base, "-o", str(multi), "--n-hosts", "2"]
    # host 0: healthy, blocks at the part-merge barrier while host 1 is down
    # (fs transport; SCTAG_SYNC_TIMEOUT bounds the wait)
    h0 = subprocess.Popen(port_cmd(*argv, "--host-id", "0"), env=port_env(),
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        # host 1, attempt 1: crashes mid-stage (match_segments raises)
        crash = textwrap.dedent(
            """
            import sys
            import sctagger_tpu_torch.stages.match_trie as mt

            def boom(*a, **k):
                raise RuntimeError("injected host crash")

            mt.match_segments = boom
            from sctagger_tpu_torch.cli import main
            main(sys.argv[1:])
            """
        )
        h1a = subprocess.run([sys.executable, "-c", crash, *argv, "--host-id", "1"],
                             env=port_env(), capture_output=True, text=True,
                             timeout=TIMEOUT)
        assert h1a.returncode != 0
        assert "injected host crash" in h1a.stderr
        assert h0.poll() is None, "healthy host must keep waiting, not die"

        # host 1, attempt 2: plain relaunch; recovery needs only this host
        run_port([*argv, "--host-id", "1"])
        err0 = h0.communicate(timeout=TIMEOUT)[1]
        assert h0.returncode == 0, err0[-2000:]
    finally:
        if h0.poll() is None:
            h0.kill()
            h0.wait()

    assert multi.read_bytes() == single.read_bytes() == jax_out.read_bytes()
    assert multi.read_text().count("\n") > 10
    assert not list(tmp_path.glob("*.part"))  # the merge cleaned up
