"""The roofline arithmetic."""

import pytest

from knnbench import roofline


def test_groupmin_f32_least_time():
    # PERF.md's bound of the 1M l2 pass 1: 2048 queries over 1,007,616 rows of 128
    t, by = roofline.groupmin_f32_least_s(2048, 1_007_616, 128)
    assert by == "operations"
    assert round(t * 1e3, 3) == 7.885


def test_sparse_least_time_by_bytes_and_by_operations():
    t, by = roofline.sparse_qdense_least_s(2_000_000_000, 120_000_000, 100_000, 2048, 1_000_000)
    assert by == "bytes"
    assert t == pytest.approx((8 * 120_100_000 + 4 * 2048 * 1_000_000) / 3.35e12)
    t, by = roofline.sparse_qdense_least_s(10**13, 10, 10, 1, 1)
    assert by == "operations" and t == pytest.approx(2e13 / 67e12)
