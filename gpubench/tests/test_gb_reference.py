"""The plain references against brute force on tiny cases."""

import numpy as np
import pytest
import torch

from gpubench import seqs
from gpubench.reference import alt, edit, lr, match

CPU = torch.device("cpu")


def dp_last_row(p, t, shw=False):
    """Textbook DP: D[m][j] for j = 1..len(t)."""
    m, n = len(p), len(t)
    D = np.zeros((m + 1, n + 1), np.int64)
    D[:, 0] = np.arange(m + 1)
    for j in range(1, n + 1):
        D[0, j] = j if shw else 0
        for i in range(1, m + 1):
            D[i, j] = min(D[i - 1, j - 1] + (p[i - 1] != t[j - 1]), D[i - 1, j] + 1, D[i, j - 1] + 1)
    return D[m, 1:]


def rand(rng, n):
    return rng.integers(0, 4, n).astype(np.int16)


@pytest.mark.parametrize("shw", [False, True])
def test_dp_columns_equal_textbook(shw):
    rng = np.random.default_rng(1)
    pats = np.stack([rand(rng, 6) for _ in range(5)])
    texts = np.stack([rand(rng, 15) for _ in range(7)])
    texts[0, 3] = 4  # a code that matches nothing
    cols = np.stack([c.clone().numpy() for _, c in edit.dp_columns(torch.from_numpy(pats),
                                                           torch.from_numpy(texts), shw)], 2)
    for s in range(7):
        for p in range(5):
            t = [int(x) if x < 4 else 9 for x in texts[s]]
            assert list(cols[s, p]) == list(dp_last_row(list(pats[p]), t, shw))


def test_match_reads_equal_brute_force():
    rng = np.random.default_rng(2)
    bcs = rng.integers(0, 4, (30, 8)).astype(np.uint8)
    bcs[1] = bcs[0]  # a duplicate: ties on both
    seg = rng.integers(0, 4, (40, 14)).astype(np.uint8)
    seg[:20, 3:11] = bcs[rng.integers(0, 30, 20)]
    lens = rng.integers(6, 15, 40)
    got = match.match_reads(bcs, seg, lens, np.arange(40), 2, CPU, block=7)
    pats = match.patterns(bcs)
    for r in range(40):
        d = [int(dp_last_row(list(p), list(seg[r, :lens[r]])).min()) for p in pats]
        best = min(d)
        if best > 2:
            assert got[r] is None
        else:
            assert got[r][0] == best
            assert list(got[r][1]) == [p for p in range(len(pats)) if d[p] == best]


def test_longest_starts_follow_the_reverse_prefix_pass():
    rng = np.random.default_rng(3)
    a2 = rand(rng, 7).astype(np.int16)
    reads = rng.integers(0, 4, (12, 40)).astype(np.uint8)
    rid = np.repeat(np.arange(12), 3)
    end = rng.integers(0, 40, rid.size)
    got = lr.longest_starts(a2, reads, rid, end, CPU)
    for i in range(rid.size):
        t = list(reads[rid[i], : end[i] + 1][::-1])
        sc = dp_last_row(list(a2[::-1]), t, shw=True)
        k = int(np.flatnonzero(sc == sc.min()).max())
        assert got[i] == end[i] - k


def test_word_table_keeps_the_last_word():
    k = 4
    wl = np.array([seqs.codes_to_keys(np.array([c]))[0] for c in
                   ([0, 1, 2, 3], [0, 0, 3, 3], [3, 3, 0, 0])])
    keys, vals = alt.word_table(wl, k)
    d = {}
    for i, w in enumerate(wl):
        d[int(w)] = i
    rc = alt.revcomp_keys(wl, k)
    for i, w in enumerate(rc):
        d[int(w)] = -i
    assert dict(zip(keys.tolist(), vals.tolist())) == d


def test_alt_rows_equal_brute_force():
    rng = np.random.default_rng(4)
    k = 5
    wl = seqs.unique_kmers(rng, 40, k)
    n = 600
    seg = rng.integers(0, 4, (n, 9)).astype(np.uint8)
    pick = rng.integers(0, 40, n) % rng.integers(1, 40, n)
    seg[:, 2:7] = seqs.keys_to_codes(wl[pick], k)
    rc = rng.random(n) < 0.5
    seg[rc] = seqs.revcomp_rows(seg[rc], np.full(rc.sum(), 9))
    seg[5, 4] = 4
    lens = np.full(n, 9)
    is_na = rng.random(n) < 0.1
    lens[is_na] = 0
    got = alt.expected_rows(wl, seg, lens, is_na, k, 25, 3, 0.05, CPU)
    words = {}
    for i, w in enumerate(wl):
        words[tuple(seqs.keys_to_codes(np.array([w]), k)[0])] = i
    for i, w in enumerate(wl):
        words[tuple(3 - seqs.keys_to_codes(np.array([w]), k)[0][::-1])] = -i
    counts, order = {}, []
    for r in range(n):
        if is_na[r]:
            continue
        hits = [words[tuple(seg[r, j:j + k])] for j in range(lens[r] - k + 1)
                if tuple(seg[r, j:j + k]) in words]
        if len(hits) == 1:
            b = abs(hits[0])
            if b not in counts:
                order.append(b)
            counts[b] = counts.get(b, 0) + 1
    ranked = sorted(order, key=lambda b: -counts[b])[:25]
    total = sum(counts[b] for b in ranked)
    last = 0
    for last in range(0, len(ranked), 3):
        if sum(counts[b] for b in ranked[last:last + 3]) / total < 0.05:
            break
    assert got == [(b, counts[b]) for b in ranked[: last + 3]]


def test_lr_locations_equal_brute_force():
    """Strand, distance and every location of each read, as the expected
    TSV derives them, against the textbook DP."""
    rng = np.random.default_rng(5)
    adapter = "CTACACGA"
    a1 = lr._codes(adapter)
    a2 = (3 - a1[::-1]).astype(np.int16)
    n, w = 30, 50
    reads = rng.integers(0, 4, (n, w)).astype(np.uint8)
    lens = rng.integers(20, 51, n)
    reads[:10, 3:11] = a1
    reads[10:20, 5:13] = a2
    d, ends = lr.end_scores(np.stack([a1, a2]), reads, lens, CPU, block=8)
    for r in range(n):
        t = list(reads[r, : lens[r]])
        s1, s2 = dp_last_row(list(a1), t), dp_last_row(list(a2), t)
        assert d[0, r] == s1.min() and d[1, r] == s2.min()
        for p, sc in ((0, s1), (1, s2)):
            rr, ee = ends[p]
            assert sorted(ee[rr == r].tolist()) == np.flatnonzero(sc == sc.min()).tolist()


def test_peak_ranges_on_a_made_histogram():
    locs = np.concatenate([np.full(500, 10), np.full(300, 11), np.full(200, 12),
                           np.full(400, 100), np.arange(200, 205)])
    assert lr.peak_ranges(locs) == [(10, 12), (100, 100)]
    assert lr.peak_ranges(np.zeros(0, np.int64)) == []
