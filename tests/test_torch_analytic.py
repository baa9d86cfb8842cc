"""ionflux_torch.solver.analytic (the exact piecewise-constant propagators)
against ionflux.solver.analytic and against the f64 scipy oracle of
tests/test_analytic.py, at that test's bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from ionflux.models.registry import HH_B06 as J_HH_B06
from ionflux.solver import analytic as JA
from ionflux_torch.models.registry import HH_B06, MARKOV_B06
from ionflux_torch.solver import analytic as TA

from _torch_helpers import assert_close

DT = 0.1
# The same associative_scan tree in both packages, but torch's exp and XLA's
# differ by an ulp at some arguments.  On the lattice (hh_solve_analytic)
# every sub-interval of a constant segment has the same voltage, so such an
# ulp in its map is the same in each of the segment's ~200 sub-intervals and
# compounds linearly (the correlated bias ionflux/solver/analytic.py
# describes): 1e-5 on gates in [0, 1].  The segment form evaluates each
# knot's exponential once: 2e-6.
LATTICE_TOL = 1e-5
SEG_TOL = 2e-6


def _staircase(seed=3, n_levels=6, knots_per=50):
    rng = np.random.RandomState(seed)
    levels = rng.uniform(-120, 60, n_levels)
    return np.repeat(levels, knots_per).astype(np.float32)


def _p8(scale=None):
    p = np.array([float(x) for x in HH_B06])
    if scale is not None:
        p = p[None] * scale
    return p.astype(np.float32)


def _scipy_hh(v, p, y0=(0.0, 1.0)):
    t = np.arange(v.size) * DT

    def rhs(tt, y):
        vv = np.interp(tt, t, v.astype(np.float64))
        k1 = p[0] * np.exp(p[1] * vv)
        k2 = p[2] * np.exp(-p[3] * vv)
        k3 = p[4] * np.exp(p[5] * vv)
        k4 = p[6] * np.exp(-p[7] * vv)
        return [k1 * (1 - y[0]) - k2 * y[0], -k3 * y[1] + k4 * (1 - y[1])]

    return solve_ivp(rhs, (0, t[-1]), list(y0), t_eval=t, rtol=1e-11,
                     atol=1e-13, method="LSODA").y.T


def test_expm1_accurate_within_an_ulp_of_jax():
    """The series (|x| < 0.5) equal bit for bit; beyond it exp(x) - 1
    within one ulp of exp(x), where torch's exp and XLA's may differ."""
    x = np.concatenate([-np.logspace(-7, 1, 400), np.logspace(-7, 0.5, 50),
                        [0.0, 0.4999, 0.5, -0.5, -np.inf,
                         np.nan]]).astype(np.float32)
    got = TA._expm1_accurate(torch.from_numpy(x)).numpy()
    want = np.asarray(JA._expm1_accurate(jnp.asarray(x)))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    series = fin & (np.abs(x) < 0.5)
    assert np.array_equal(got[series], want[series])
    w = want[fin].astype(np.float32)
    ulp = np.maximum(np.spacing(np.abs(w)), np.spacing(np.abs(w + 1.0)))
    assert np.all(np.abs(got[fin] - want[fin]) <= ulp)
    assert got[-2] == -1.0 and np.isnan(got[-1])


def test_hh_segments_equal():
    rs = np.random.RandomState(0)
    fam = np.stack([_staircase(seed=s) for s in (3, 4)])
    fam[:, 120:125] = rs.uniform(-50, 0, (2, 5)).astype(np.float32)
    for v in (fam[0], fam):
        got, want = TA.hh_segments(v), JA.hh_segments(v)
        assert got.n_segments == want.n_segments
        for name in ("first", "length", "is_ramp", "g", "r"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("solve", ["lattice", "seg"])
def test_hh_analytic_matches_jax_and_the_oracle(solve):
    """A population of 4 perturbed candidates with a y0 carry, and the
    single-candidate solve against the scipy oracle (5e-5, the JAX
    test's bound)."""
    v = _staircase()
    rng = np.random.RandomState(7)
    p8 = _p8(rng.uniform(0.8, 1.25, (4, 8)))
    y0 = np.array([[0.1, 0.9], [0.0, 1.0], [0.3, 0.5], [0.05, 0.7]],
                  np.float32)
    fn_t = {"lattice": TA.hh_solve_analytic,
            "seg": TA.hh_solve_analytic_seg}[solve]
    fn_j = {"lattice": JA.hh_solve_analytic,
            "seg": JA.hh_solve_analytic_seg}[solve]
    tol = {"lattice": LATTICE_TOL, "seg": SEG_TOL}[solve]
    got = fn_t(torch.from_numpy(p8), torch.from_numpy(v), DT,
               y0=torch.from_numpy(y0))
    want = fn_j(jnp.asarray(p8), jnp.asarray(v), DT, y0=jnp.asarray(y0))
    assert tuple(got.shape) == (4, v.size, 2)
    assert_close(got, want, atol=tol)
    one = fn_t(torch.from_numpy(_p8()), torch.from_numpy(v), DT).numpy()
    assert np.abs(one - _scipy_hh(v, _p8().tolist())).max() < 5e-5
    # and with HHParams, as the registry gives them
    assert np.array_equal(fn_t(HH_B06, torch.from_numpy(v), DT).numpy(),
                          one)
    want_one = fn_j(J_HH_B06, jnp.asarray(v), DT)
    assert_close(one, want_one, atol=tol)


def test_hh_seg_reuses_a_family_structure():
    """seg from the union of two sweeps serves each of them."""
    fam = np.stack([_staircase(seed=s) for s in (3, 4)])
    seg = TA.hh_segments(fam)
    p8 = torch.from_numpy(_p8())
    for v in fam:
        got = TA.hh_solve_analytic_seg(p8, torch.from_numpy(v), DT, seg=seg)
        want = JA.hh_solve_analytic_seg(jnp.asarray(_p8()), jnp.asarray(v),
                                        DT, seg=JA.hh_segments(fam))
        assert_close(got, want, atol=SEG_TOL)


def test_markov_analytic_matches_jax_and_conserves():
    v = _staircase()
    got = TA.markov_solve_analytic(MARKOV_B06, torch.from_numpy(v), DT)
    from ionflux.models.registry import MARKOV_B06 as J_MARKOV_B06
    want = JA.markov_solve_analytic(J_MARKOV_B06, jnp.asarray(v), DT)
    assert tuple(got.shape) == (v.size, 6)
    # 3e-5: torch.linalg.matrix_exp (a Taylor polynomial with scaling and
    # squaring) and jax.scipy.linalg.expm (Pade) round each f32 propagator
    # differently, and in a constant segment that difference is the same in
    # every sub-interval and compounds over the ~200 of them (measured
    # 1.7e-5)
    assert_close(got, want, atol=3e-5)
    assert np.abs(got.numpy().sum(-1) - 1.0).max() < 1e-4
    gen = TA.markov_generator(MARKOV_B06, torch.linspace(-120, 60, 7))
    assert np.abs(gen.numpy().sum(axis=-2)).max() < 1e-6


def test_wild_candidate_gives_nonfinite_not_a_hang():
    """A candidate at the 10x bound overflows its f32 rate p1 e^{p2 V}: the
    propagators give non-finite values (the objectives' inf sentinel)."""
    v = _staircase()
    p = _p8()
    p[1] = 10.0 * p[1] * 30.0
    for fn in (TA.hh_solve_analytic, TA.hh_solve_analytic_seg):
        ys = fn(torch.from_numpy(p), torch.from_numpy(v), DT).numpy()
        assert not np.all(np.isfinite(ys))
        want = {TA.hh_solve_analytic: JA.hh_solve_analytic,
                TA.hh_solve_analytic_seg: JA.hh_solve_analytic_seg}[fn](
            jnp.asarray(p), jnp.asarray(v), DT)
        np.testing.assert_array_equal(np.isfinite(ys),
                                      np.isfinite(np.asarray(want)))
