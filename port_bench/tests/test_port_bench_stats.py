"""The percentile arithmetic."""
import numpy as np
import pytest

from port_bench.stats import percentile


@pytest.mark.parametrize("n", [1, 2, 7, 20, 201])
@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_percentile_matches_numpy_linear(n, q):
    values = np.random.default_rng(n).normal(50.0, 5.0, n)
    assert percentile(values, q) == pytest.approx(float(np.percentile(values, q)), rel=1e-12)


def test_percentile_by_hand():
    # 20 values 1..20: rank 0.95 * 19 = 18.05 -> 19 + 0.05 * (20 - 19).
    assert percentile(range(1, 21), 95) == pytest.approx(19.05)
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_percentile_refuses_nothing_and_bad_q():
    with pytest.raises(ValueError):
        percentile([], 50)
    with pytest.raises(ValueError):
        percentile([1.0], 101)

