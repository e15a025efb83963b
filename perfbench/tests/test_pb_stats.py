"""The end-to-end arithmetic over a window that holds a stall."""

import pytest

from perfbench.core.stats import percentile, rate


def test_percentile_is_nearest_rank_over_every_sample():
    values = [10.0] * 94 + [500.0] * 6  # six stalls in a hundred steps
    assert percentile(values, 95) == 500.0
    assert percentile(values[:-2], 95) == 10.0  # four stalls: under the tail
    assert percentile([3.0], 95) == 3.0
    assert percentile(list(range(1, 101)), 50) == 50
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_counts_the_stall_in_the_window():
    stamps = [0.0] + [0.1 * i for i in range(1, 11)] + [2.0]  # a 1 s stall at the end
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    assert len(steps) == 11 and steps[-1] == pytest.approx(1.0)
    window = stamps[-1] - stamps[0]
    assert rate(64 * len(steps), window) == pytest.approx(64 * 11 / 2.0)
    assert percentile(steps, 95) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        rate(1, 0.0)
