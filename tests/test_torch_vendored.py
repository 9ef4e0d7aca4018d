"""The port's own copies of the JAX package's host modules
(sctagger_tpu_torch.{core,io,native,pipeline,utils,cli,observability,plots}
and ops.topk_count) against their originals on the same numpy-seeded inputs
(CPU). Tolerance: exact equality; TSV, FASTQ and BAM results byte for byte,
each side through its own native library."""

import gzip
import json
import pathlib

import numpy as np
import pytest

import sctagger_tpu.cli as jcli
import sctagger_tpu.core.packing as jpack
import sctagger_tpu.core.ranges as jranges
import sctagger_tpu.io.fastq as jfastq
import sctagger_tpu.io.tsv as jtsv
import sctagger_tpu.native.build as jbuild
import sctagger_tpu.observability as jobs
import sctagger_tpu.utils.misc as jmisc
import sctagger_tpu_torch.cli as tcli
import sctagger_tpu_torch.core.packing as tpack
import sctagger_tpu_torch.core.ranges as tranges
import sctagger_tpu_torch.io.fastq as tfastq
import sctagger_tpu_torch.io.tsv as ttsv
import sctagger_tpu_torch.native.build as tbuild
import sctagger_tpu_torch.observability as tobs
import sctagger_tpu_torch.utils as tutils

ROOT = pathlib.Path(__file__).resolve().parents[1]

# copies kept byte for byte (imports are all relative, so none changed)
VERBATIM = [
    "core/packing.py", "core/ranges.py", "io/fastq.py", "io/tsv.py", "plots.py",
    "native/fastq_reader.cpp", "native/tsv_reader.cpp", "native/tsv_writer.cpp",
    "native/range_search.cpp", "native/adapter_d0.cpp", "native/adapter_d1.cpp",
    "native/adapter_verify.h",
    "core/cutoff.py", "io/bam.py", "pipeline/__init__.py", "pipeline/checkpoint.py",
    "native/bam_reader.cpp", "native/hash_table.cpp", "native/exact_probe.cpp",
    "io/sharding.py",
]


def _dna(rng, n: int, alphabet: str = "ACGT") -> str:
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), size=n))


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_verbatim(rel):
    assert (ROOT / "sctagger_tpu_torch" / rel).read_bytes() == \
        (ROOT / "sctagger_tpu" / rel).read_bytes()


def test_packing_tables_and_encoders():
    rng = np.random.default_rng(0)
    for name in ("STRICT_TABLE", "LENIENT_TABLE", "CODE_A", "CODE_C", "CODE_G",
                 "CODE_T", "CODE_PAD"):
        np.testing.assert_array_equal(getattr(tpack, name), getattr(jpack, name))
    seqs = [_dna(rng, int(rng.integers(0, 40)), "ACGTNacgtn") for _ in range(50)]
    for table in ("STRICT_TABLE", "LENIENT_TABLE"):
        want = jpack.encode_seqs(seqs, 48, getattr(jpack, table))
        got = tpack.encode_seqs(seqs, 48, getattr(tpack, table))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for s in seqs[:10]:
        assert tpack.rev_compl(s) == jpack.rev_compl(s)
        np.testing.assert_array_equal(tpack.encode_str(s), jpack.encode_str(s))
    idx = rng.permutation(len(seqs))[:20]
    for a, b in zip(tpack.encode_rows(seqs, idx, 48), jpack.encode_rows(seqs, idx, 48)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpack.seq_lengths(seqs), jpack.seq_lengths(seqs))
    codes, lens = jpack.encode_seqs(seqs, 48)
    np.testing.assert_array_equal(tpack.revcomp_codes(codes, lens),
                                  jpack.revcomp_codes(codes, lens))
    for a, b in zip(tpack.pack_kmers_from_codes(codes, lens, 8),
                    jpack.pack_kmers_from_codes(codes, lens, 8)):
        np.testing.assert_array_equal(a, b)


def test_ranges():
    rng = np.random.default_rng(1)
    locs_f = np.concatenate([rng.integers(20, 40, 900), rng.integers(0, 400, 100)])
    locs_r = np.concatenate([rng.integers(-60, -30, 700), rng.integers(-400, 0, 80)])
    want = jranges.detect_ranges(locs_f, locs_r, quiet=True)
    assert tranges.detect_ranges(locs_f, locs_r, quiet=True) == want
    n = 300
    strands = rng.integers(-1, 2, n).astype(np.int8)
    dists = np.where(strands >= 0, rng.integers(0, 6, n), -1).astype(np.int32)
    counts = np.where(strands >= 0, rng.integers(0, 4, n), 0).astype(np.int64)
    flat = rng.integers(-80, 80, int(counts.sum())).astype(np.int64)
    for include_end in (False, True):
        jm = [jranges.RangeMembership(r, include_end) for r in want]
        tm = [tranges.RangeMembership(r, include_end) for r in want]
        for a, b in zip(tranges.filter_alignments(strands, dists, flat, counts, tm, 20),
                        jranges.filter_alignments(strands, dists, flat, counts, jm, 20)):
            np.testing.assert_array_equal(a, b)


ARGV_CASES = [
    ["extract_lr_bc", "-r", "a.fq"],
    ["extract_lr_bc", "-r", "a.fq", "b.fq.gz", "-g", "f1:40", "r1:45", "-z",
     "-t", "4", "-sa", "ACGTACGTAC", "-o", "o.tsv.gz", "-p", "p.png",
     "--num-bp-after", "7"],
    ["extract_sr_bc", "-i", "in.bam", "--thresh", "0.01", "--step-size", "500"],
    ["extract_sr_bc_from_lr", "-i", "lr.tsv.gz", "-wl", "wl.txt", "--max-barcode-cnt", "9"],
    ["match_trie", "-lr", "lr.tsv", "-sr", "sr.tsv"],
    ["match_trie", "-lr", "lr.tsv", "-sr", "sr.tsv", "-mr", "3", "-bl", "12", "-t", "2",
     "-m", "4", "-p", "x.png", "-o", "out.tsv.gz", "--n-hosts", "2", "--host-id", "1"],
    ["pipeline", "-c", "cfg.yaml", "-s", "a", "b", "--from-lr-only"],
]


@pytest.mark.parametrize("argv", ARGV_CASES, ids=lambda a: a[0])
def test_parse_args_same_namespace(argv):
    assert vars(tcli.parse_args(argv)) == vars(jcli.parse_args(argv))


@pytest.mark.parametrize("argv", [
    ["match_trie", "-lr", "a", "-sr", "b", "-mr", "16"],
    ["extract_lr_bc", "-r", "a.fq", "-g", "f1:40", "f30:50"],
])
def test_parse_args_same_errors(argv):
    with pytest.raises(AssertionError):
        jcli.parse_args(argv)
    with pytest.raises(AssertionError):
        tcli.parse_args(argv)


def test_utils_and_stage_stats(tmp_path, monkeypatch):
    assert tutils.cdiv(17, 4) == jmisc.cdiv(17, 4) == 5
    assert tutils.round_up(17, 8) == jmisc.round_up(17, 8) == 24
    assert list(tutils.batch_iter(10, 4)) == list(jmisc.batch_iter(10, 4))
    np.testing.assert_array_equal(tutils.full_fast((3, 2), 7, np.int16),
                                  jmisc.full_fast((3, 2), 7, np.int16))
    out = tmp_path / "stats.jsonl"
    monkeypatch.setenv("SCTAG_STATS", str(out))
    for mod in (jobs, tobs):
        st = mod.StageStats("s")
        st.count("reads", 3)
        st.emit()
    a, b = (json.loads(ln) for ln in out.read_text().splitlines())
    assert a.pop("wall_s") >= 0 and b.pop("wall_s") >= 0
    assert a == b


def test_native_library_is_the_ports_own():
    lib = tbuild.ensure_built()
    assert lib.parent == ROOT / "build" / "sctagger_tpu_torch"
    assert lib != jbuild._LIB and lib.name.startswith("libsctag_io_")
    assert tbuild.load() is tbuild.load()


def _fastq(path: pathlib.Path, rng, n: int) -> None:
    recs = []
    for i in range(n):
        s = _dna(rng, int(rng.integers(0, 300)), "ACGTACGTACGTN")
        recs.append(f"@r{i} extra\n{s}\n+\n{'I' * len(s)}\n")
    path.write_bytes(gzip.compress("".join(recs).encode()))


def test_fastq_native_same_records(tmp_path):
    rng = np.random.default_rng(2)
    fq = tmp_path / "a.fastq.gz"
    _fastq(fq, rng, 500)
    tn, ts = tfastq.read_fastqs([str(fq)], quiet=True)
    jn, js = jfastq.read_fastqs([str(fq)], quiet=True)
    assert isinstance(ts, tfastq.SeqBuffer) and tn == jn
    np.testing.assert_array_equal(ts.buf, js.buf)
    np.testing.assert_array_equal(ts.offs, js.offs)
    idx = rng.permutation(len(ts))[:200]
    for a, b in zip(ts.encode_packed(idx, 320, tpack.STRICT_TABLE),
                    js.encode_packed(idx, 320, jpack.STRICT_TABLE)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.encode_batch(idx, 320, tpack.STRICT_TABLE, 4),
                    js.encode_batch(idx, 320, jpack.STRICT_TABLE, 4)):
        np.testing.assert_array_equal(a, b)
    assert list(ts.take(idx)) == list(js.take(idx))
    tb = list(tfastq.read_fastqs_stream([str(fq)], batch_records=128, quiet=True))
    jb = list(jfastq.read_fastqs_stream([str(fq)], batch_records=128, quiet=True))
    assert [n for n, _ in tb] == [n for n, _ in jb]
    assert [list(s) for _, s in tb] == [list(s) for _, s in jb]


def test_tsv_native_same_bytes(tmp_path):
    rng = np.random.default_rng(3)
    fq = tmp_path / "a.fastq.gz"
    _fastq(fq, rng, 300)
    names, seqs = tfastq.read_fastqs([str(fq)], quiet=True)
    jnames, jseqs = jfastq.read_fastqs([str(fq)], quiet=True)
    n = len(seqs)
    valid = rng.random(n) < 0.7
    dist = np.where(valid, rng.integers(0, 6, n), -1).astype(np.int64)
    loc = rng.integers(-300, 300, n).astype(np.int64)
    s = rng.integers(-50, 50, n).astype(np.int64)
    e = s + rng.integers(0, 40, n)
    outs = []
    for mod, nm, sq, tag in ((ttsv, names, seqs, "t"), (jtsv, jnames, jseqs, "j")):
        p = tmp_path / f"lr_{tag}.tsv.gz"
        assert mod.write_lr_tsv_gz_native(str(p), nm, sq, dist, loc, s, e, valid)
        outs.append(gzip.decompress(p.read_bytes()))
    assert outs[0] == outs[1] and outs[0].count(b"\n") == n
    lr = tmp_path / "lr.tsv"
    lr.write_bytes(outs[0])
    # the native readers themselves (the public reader falls back silently)
    got = ttsv._read_lr_segments_native(str(lr))
    want = jtsv._read_lr_segments_native(str(lr))
    assert isinstance(got[3], tfastq.SeqBuffer)
    assert got[:3] == want[:3] and list(got[3]) == list(want[3])
    sr = tmp_path / "sr.tsv"
    sr.write_text("".join(f"{_dna(rng, 16)}\t{i}\n" for i in range(20)))
    assert ttsv.read_sr_barcodes_tsv(str(sr)) == jtsv.read_sr_barcodes_tsv(str(sr))


def test_count_and_rank_host():
    import sctagger_tpu.ops.topk_count as jtopk
    import sctagger_tpu_torch.ops.topk_count as ttopk

    rng = np.random.default_rng(4)
    keys = rng.integers(0, 50, 2000).astype(np.uint32)
    valid = rng.random(2000) < 0.8
    for v in (None, valid):
        for a, b in zip(ttopk.count_and_rank_host(keys, v),
                        jtopk.count_and_rank_host(keys, v)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    empty = ttopk.count_and_rank_host(np.zeros(0, np.uint32))
    assert [a.size for a in empty] == [0, 0]


def test_bam_reader_same_counts(tmp_path):
    """The port's BAM reader (its own library) == the JAX package's, whole
    file and in byte ranges."""
    import sctagger_tpu.io.bam as jbam
    import sctagger_tpu_torch.io.bam as tbam
    from bamgen import write_bam

    rng = np.random.default_rng(6)
    pool = [_dna(rng, 16) for _ in range(30)]
    alns = {c: [{"flag": int(rng.choice([0, 16, 256, 1024])), "name": f"q{i}",
                 "pos": i, "tags": [["CB", pool[int(rng.integers(30))] + "-1"]]}
                for i in range(1500)] for c in ("chr1", "chr2")}
    path = str(tmp_path / "a.bam")
    write_bam(path, ["chr1", "chr2"], alns)
    got, want = tbam.extract_cb_counts(path), jbam.extract_cb_counts(path)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    size = tbam.bam_file_size(path)
    assert size == jbam.bam_file_size(path) > 0
    for start, end, skip, hdr in ((0, size // 2, 0, True), (size // 2, size, -1, False)):
        t = tbam.extract_cb_counts_range(path, start, end, skip, parse_header=hdr)
        j = jbam.extract_cb_counts_range(path, start, end, skip, parse_header=hdr)
        assert t[0] == j[0] and t[3:] == j[3:]
        for a, b in zip(t[1:3], j[1:3]):
            np.testing.assert_array_equal(a, b)


def test_profile_trace(tmp_path, monkeypatch):
    """SCTAG_PROFILE=<dir>: stage_scope writes a torch.profiler Chrome trace
    of the stage body into <dir> (CPU activity here)."""
    import torch

    monkeypatch.setenv("SCTAG_PROFILE", str(tmp_path / "prof"))
    with tobs.stage_scope("probe_stage") as st:
        with torch.profiler.record_function("sctag_marker"):
            torch.ones(8).sum()
        st.count("x")
    traces = list((tmp_path / "prof").glob("probe_stage.*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "sctag_marker" for e in events)
