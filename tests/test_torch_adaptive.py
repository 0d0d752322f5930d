"""The port's copy of ``core/adaptive.py`` (the dropout-robust floored
Markov policy) against the reference on ``tests/test_adaptive.py``'s
grids: every output bitwise, every error message the same."""
import numpy as np
import pytest

from repro.core import adaptive as ref
from repro_torch.core import adaptive as port

# (n, k, m, eps) of tests/test_adaptive.py, plus its property test's range
GRID = [(100, 15, 10, 0.0), (100, 15, 10, 0.5), (100, 15, 10, 0.3),
        (50, 10, 8, 0.2), (100, 15, 10, 1.0), (5, 1, 10, 0.7), (150, 149, 2, 0.9),
        (149, 1, 298, 0.01), (20, 7, 4, 0.45)]


@pytest.mark.parametrize("n,k,m,eps", GRID)
def test_floored_probs_equal(n, k, m, eps):
    np.testing.assert_array_equal(port.floored_probs(n, k, m, eps),
                                  ref.floored_probs(n, k, m, eps))


@pytest.mark.parametrize("n,k,m,eps", GRID)
@pytest.mark.parametrize("d", [0.0, 0.01, 0.05, 0.08])
def test_dropout_update_probability_equal(n, k, m, eps, d):
    p = ref.floored_probs(n, k, m, eps)
    assert port.dropout_update_probability(p, d) == ref.dropout_update_probability(p, d)


@pytest.mark.parametrize("grid", [None, np.linspace(0, 1, 6)])
def test_tradeoff_curve_equal(grid):
    got = port.tradeoff_curve(100, 15, 10, d=0.01, eps_grid=grid)
    exp = ref.tradeoff_curve(100, 15, 10, d=0.01, eps_grid=grid)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)


def test_eps_out_of_range_message():
    for mod in (port, ref):
        with pytest.raises(ValueError, match=r"^eps in \[0,1\]$"):
            mod.floored_probs(100, 15, 10, 1.5)
