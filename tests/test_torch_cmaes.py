"""ionflux_torch.fit.cmaes against ionflux.fit.cmaes: both are host numpy in
float64 with the same generator, so the same seed and objective give the
same iterates (held to 1e-12)."""

import numpy as np
import pytest

from ionflux.fit import cmaes as JC
from ionflux_torch.fit import cmaes as TC

TOL = 1e-12
_RS = np.random.RandomState(0)
_Q = _RS.randn(4, 4)
_Q = _Q @ _Q.T + 4.0 * np.eye(4)
_CENTRE = np.array([1.5, 0.7, 2.0, 1.1])


def quadratic(xs):
    d = np.asarray(xs) - _CENTRE
    return np.einsum("pi,ij,pj->p", d, _Q, d)


def rosenbrock(xs):
    xs = np.asarray(xs)
    return np.sum(100.0 * (xs[:, 1:] - xs[:, :-1] ** 2) ** 2
                  + (1.0 - xs[:, :-1]) ** 2, axis=1)


def some_inf(xs):
    """Members with x0 above the start score inf, as a diverged solve does."""
    fs = quadratic(xs)
    return np.where(np.asarray(xs)[:, 0] > 1.2, np.inf, fs)


def _same(rt, rj):
    assert rt.iterations == rj.iterations
    assert rt.evaluations == rj.evaluations
    assert rt.hit_max_iterations == rj.hit_max_iterations
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=TOL)
    assert abs(rt.fx - rj.fx) <= TOL * max(1.0, abs(rj.fx))
    assert len(rt.history) == len(rj.history)
    np.testing.assert_allclose(np.array(rt.history), np.array(rj.history),
                               rtol=TOL, atol=TOL)


X0 = np.array([1.2, 1.0, 1.6, 0.9])


@pytest.mark.parametrize("objective", [quadratic, rosenbrock, some_inf])
@pytest.mark.parametrize("log_transform", [True, False])
@pytest.mark.parametrize("bounded", [True, False])
def test_cmaes_iterates_equal(objective, log_transform, bounded):
    kw = dict(sigma0=0.1 * X0, log_transform=log_transform, seed=3,
              bounds=(0.1 * X0, 10.0 * X0) if bounded else None,
              max_iterations=40)
    rt = TC.cmaes(objective, X0, **kw)
    rj = JC.cmaes(objective, X0, **kw)
    _same(rt, rj)
    assert rt.iterations == 40 and rt.evaluations == 40 * 8
    assert np.isfinite(rt.fx) and rt.fx < float(objective(X0[None])[0])
    if bounded:
        assert np.all(rt.x >= 0.1 * X0) and np.all(rt.x <= 10.0 * X0)


def test_cmaes_stops_on_unchanged_iterations_or_max():
    kw = dict(sigma0=0.1 * X0, seed=0, max_unchanged_iterations=5,
              unchanged_threshold=1e-3)
    rt = TC.cmaes(quadratic, X0, **kw)
    rj = JC.cmaes(quadratic, X0, **kw)
    _same(rt, rj)
    assert not rt.hit_max_iterations and rt.iterations > 5
    cut = TC.cmaes(quadratic, X0, max_iterations=3, **kw)
    _same(cut, JC.cmaes(quadratic, X0, max_iterations=3, **kw))
    assert cut.hit_max_iterations and cut.iterations == 3
    assert [it for it, _ in cut.history] == [1, 2, 3]
    # the best never gets worse
    assert all(b <= a for (_, a), (_, b) in zip(rt.history, rt.history[1:]))


def test_default_popsize_and_what_is_ported():
    for n in (1, 2, 4, 9, 30):
        assert TC._default_popsize(n) == JC._default_popsize(n)
    assert TC._default_popsize(4) == 8
    assert TC.CMAESResult.__dataclass_fields__.keys() == (
        JC.CMAESResult.__dataclass_fields__.keys())
    # cmaes_onchip is ported (tests/test_torch_cmaes_onchip.py);
    # shard_objective waits for torch.distributed
    assert hasattr(TC, "cmaes_onchip") and not hasattr(
        TC, "shard_objective")


@pytest.mark.parametrize("sigma0", [None, 0.3])
def test_fmin_equal(sigma0):
    def f(x):
        return float(rosenbrock(x[None])[0])

    x_t, f_t = TC.fmin(f, X0, sigma0=sigma0, max_iter=30, seed=1)
    x_j, f_j = JC.fmin(f, X0, sigma0=sigma0, max_iter=30, seed=1)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=TOL)
    assert abs(f_t - f_j) <= TOL and f_t < f(X0)
