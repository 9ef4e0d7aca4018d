"""The frozen yardstick's arithmetic."""

import math

from gpubench import roofline


def test_peak_is_the_published_issue_rate():
    assert math.isclose(roofline.LANE_PEAK, 132 * 4 * 32 * 1.98e9)
    assert math.isclose(roofline.LANE_PEAK / 1e12, 33.454, rel_tol=1e-4)


def test_lane_share():
    assert roofline.lane_share(16) == 0.5
    assert roofline.lane_share(22) == 22 / 32
    assert roofline.lane_share(40) == 1.0


def test_sweep_and_slots_seconds():
    # 181,156 reads x 50,000 patterns x 24 bp x 22.25 ops x 16/32
    want = 181_156 * 50_000 * 24 * 22.25 * 0.5 / roofline.LANE_PEAK
    assert math.isclose(roofline.sweep_seconds(181_156, 50_000, 24.0, 16), want)
    assert math.isclose(want, 0.0723, rel_tol=1e-2)
    want = 2_000_000 * 2 * 28 * 22 / 32 / roofline.LANE_PEAK
    assert math.isclose(roofline.slots_seconds(2_000_000, 22), want)


def test_share_pct():
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
    # a kernel that packs two barcodes a word does half the work a cell and
    # still reads at most 100% when it runs at the issue rate
    packed = 0.5 * 22.25 / roofline.LANE_PEAK
    assert roofline.share_pct(roofline.sweep_seconds(1, 1, 1, 16), packed) <= 100.0
