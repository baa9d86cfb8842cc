"""The port's exp-fit tools (ionflux_torch/ops/expfit.py) against the JAX
package's (ionflux/ops/expfit.py), numpy and scipy on both sides: the
closed forms bit for bit, the fits on numpy-seeded segments to 1e-8 in
float64 (the CMA-ES fallback is each package's own ``fit.cmaes.fmin``,
seeded through ``np.random.default_rng``)."""

import numpy as np
import pytest

from ionflux.ops import expfit as J
from ionflux_torch.ops import expfit as T


def _segment(kind: str, seed: int, n: int = 400, noise: float = 1e-3):
    """(t, a) on one segment: an exp curve near the reference guesses plus
    numpy noise."""
    rs = np.random.RandomState(seed)
    t = np.linspace(0.0, 300.0, n)
    x = (J.X02_TRI if kind == "tri" else J.X0_BI) * np.exp(
        0.2 * rs.randn(7 if kind == "tri" else 5))
    f = J.tri_exp if kind == "tri" else J.bi_exp
    return t, f(t, x) + noise * rs.randn(n)


def test_constants_equal():
    for name in ("X0_TRI", "X02_TRI", "X0_BI"):
        assert np.array_equal(getattr(T, name), getattr(J, name))


@pytest.mark.parametrize("name, n", [
    ("tri_exp", 7), ("dtri_exp", 7), ("d2tri_exp", 7),
    ("bi_exp", 5), ("dbi_exp", 5), ("d2bi_exp", 5)])
def test_closed_forms_bit_for_bit(name, n):
    rs = np.random.RandomState(0)
    t = np.linspace(0.0, 500.0, 257)
    for _ in range(4):
        x = rs.randn(n) * np.array([1.0, 0.01] * (n // 2) + [1.0])
        assert np.array_equal(getattr(T, name)(t, x), getattr(J, name)(t, x))


def test_is_within_and_eval_exp():
    r = np.array([3.0, 1.0, 7.5])
    for x in (0.5, 1.0, 2.0, 7.5, 8.0):
        assert T.is_within(r, x) == J.is_within(r, x)
    t = np.linspace(0.0, 100.0, 101)
    for kind, x in (("tri", J.X0_TRI), ("bi", J.X0_BI)):
        for a, b in zip(T.eval_exp(kind, t, x), J.eval_exp(kind, t, x)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("kind, restarts", [("tri", 0), ("bi", 0),
                                            ("tri", 2)])
def test_fit_exp_nelder_mead_matches_jax(kind, restarts):
    """scipy's fmin on the same float64 residual: 1e-8."""
    t, a = _segment(kind, 1)
    x_t = T.fit_exp(t, a, kind, restarts=restarts)
    x_j = J.fit_exp(t, a, kind, restarts=restarts)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-8, atol=1e-12)


def test_fit_exp_cma_fallback_matches_jax():
    """The CMA-ES fallback: each package's ``fmin`` over the numpy
    ``default_rng(0)`` stream; 1e-8."""
    t, a = _segment("tri", 2, n=200)
    x_t = T.fit_exp(t, a, "tri", J.X02_TRI, use_cma=True, max_iter=40)
    x_j = J.fit_exp(t, a, "tri", J.X02_TRI, use_cma=True, max_iter=40)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("kind", ["tri", "bi"])
def test_fit_exp_ls_and_varpro_match_jax(kind):
    """The grid-seeded varpro + LM pipeline and the varpro fit alone: 1e-8;
    the ls fit lands on the noise floor."""
    t, a = _segment(kind, 3, n=300, noise=1e-4)
    x_t = T.fit_exp_ls(t, a, kind)
    x_j = J.fit_exp_ls(t, a, kind)
    np.testing.assert_allclose(x_t, x_j, rtol=1e-8, atol=1e-12)
    f = T.tri_exp if kind == "tri" else T.bi_exp
    assert np.sqrt(np.mean((f(t, x_t) - a) ** 2)) < 2e-4
    np.testing.assert_allclose(T.fit_exp_varpro(t, a, kind, restarts=1),
                               J.fit_exp_varpro(t, a, kind, restarts=1),
                               rtol=1e-8, atol=1e-12)
