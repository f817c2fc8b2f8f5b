"""Percentiles count a failed request above any limit."""

import pytest

from benchmark import stats


def test_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0


def test_failures_rank_above_every_time():
    times = [1.0] * 90 + [None] * 10
    assert stats.percentile(times, 90) == 1.0
    assert stats.percentile(times, 95) == stats.FAILED
    assert stats.percentile([None, 5.0], 50) == 5.0


def test_no_values_is_an_error():
    with pytest.raises(ValueError):
        stats.percentile([], 95)
