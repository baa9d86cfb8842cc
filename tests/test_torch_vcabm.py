"""ionflux_torch.solver.odeint_vcabm against ionflux.

Each test mirrors a VCABM oracle test of tests/test_solver_methods.py case
for case, and also holds the port against JAX's ``odeint_vcabm`` on the
same float32 inputs: gates within 1e-4 at output times >= 50 ms from a
voltage step edge and 1e-2 anywhere.  The order choice is a threshold
(E_{k+1} < E_k <= E_{k-1}), so round-off can part the two packages' order
and step sequences (in float64 too: on the 20 mV activation step they
agree to 1e-9 relative for 26 steps, then 887 against 897 accepted): the
accepted-step counts are held within VCABM_BAND, not to equality, on the
oscillator and the activation steps.  On exp(-t) to 5 ms at rtol 1e-6 the
error terms sit at a few float32 ulps of y and the counts part far (30
against 46 accepted; the initial steps already differ in the 8th digit), so
that case holds the values only.  Blocked against stepwise: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import protocols as JP
from ionflux.models import hh_rhs as j_hh_core
from ionflux.models.registry import HH_B06 as J_HH_B06
from ionflux.models.registry import HHParams as J_HHParams
from ionflux.solver import odeint_vcabm as j_vcabm
from ionflux_torch import protocols as TP
from ionflux_torch.models import hh_rhs as t_hh_core
from ionflux_torch.models.registry import HH_B06 as T_HH_B06
from ionflux_torch.solver import odeint as t_odeint
from ionflux_torch.solver import odeint_vcabm as t_vcabm
from ionflux_torch.solver import vcabm as TV

from _torch_helpers import assert_close, np_, ts_between_edges


def j_hh_rhs(t, y, args):
    return j_hh_core(args[0], t, y, JP.voltage(args[1], t))


def t_hh_rhs(t, y, args):
    return t_hh_core(args[0], t, y, TP.voltage(args[1], t))


FAR_TOL, EDGE_TOL = 1e-4, 1e-2
VCABM_BAND = 0.10
Y0 = np.array([0.0, 1.0], np.float32)


def _counts_close(st_t, st_j, band=VCABM_BAND):
    n_t, n_j = st_t.n_accepted, int(st_j.n_accepted)
    assert abs(n_t - n_j) <= band * n_j, (n_t, n_j)


def test_vcabm_exponential_decay():
    def j_rhs(t, y, a):
        return -y

    def t_rhs(t, y, a):
        return -y

    ts = np.linspace(0.0, 5.0, 11).astype(np.float32)
    ya, st = t_vcabm(t_rhs, torch.ones(1), torch.from_numpy(ts), None,
                     return_stats=True)
    assert st.ok
    np.testing.assert_allclose(np_(ya).ravel(), np.exp(-ts), atol=1e-5)
    yj, st_j = j_vcabm(j_rhs, jnp.ones(1, jnp.float32), jnp.asarray(ts),
                       None, return_stats=True)
    assert_close(ya, yj, atol=FAR_TOL)


def test_vcabm_order_climbs_on_smooth_problem():
    """On a smooth oscillator 2 evaluations a step x steps undercut dopri5's
    6 x steps (the order really climbs); the oscillation within 1e-4; the
    states against JAX's within 1e-4 and the counts within the band."""
    def j_osc(t, y, a):
        return jnp.stack([y[1], -y[0]])

    def t_osc(t, y, a):
        return torch.stack([y[1], -y[0]])

    ts = np.linspace(0.0, 30.0, 61).astype(np.float32)
    y0 = np.array([1.0, 0.0], np.float32)
    yv, st = t_vcabm(t_osc, torch.from_numpy(y0), torch.from_numpy(ts), None,
                     rtol=1e-6, atol=1e-8, return_stats=True)
    ref = np.stack([np.cos(ts), -np.sin(ts)], axis=-1)
    assert st.ok
    assert float(np.max(np.abs(np_(yv) - ref))) < 1e-4
    _, std = t_odeint(t_osc, torch.from_numpy(y0), torch.from_numpy(ts),
                      None, rtol=1e-6, atol=1e-8, return_stats=True)
    assert 2 * st.n_steps < 6 * std.n_steps
    yj, st_j = j_vcabm(j_osc, jnp.asarray(y0), jnp.asarray(ts), None,
                       rtol=1e-6, atol=1e-8, return_stats=True)
    assert_close(yv, yj, atol=FAR_TOL)
    _counts_close(st, st_j)


@pytest.mark.parametrize("level", [20.0, -40.0])
def test_vcabm_matches_dopri5_on_step_protocol(level):
    jp = JP.activation_protocol(level)
    tp = TP.activation_protocol(level, device="cpu")
    ts = np.linspace(0.0, 8000.0, 801).astype(np.float32)
    y0 = torch.from_numpy(Y0)
    ref = t_odeint(t_hh_rhs, y0, torch.from_numpy(ts), (T_HH_B06, tp),
                   rtol=1e-7, atol=1e-9)
    ya, st = t_vcabm(t_hh_rhs, y0, torch.from_numpy(ts), (T_HH_B06, tp),
                     rtol=1e-6, atol=1e-8, return_stats=True)
    assert st.ok
    assert float(torch.max(torch.abs(ya - ref))) < 1e-3
    yj, st_j = j_vcabm(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts),
                       (J_HH_B06, jp), rtol=1e-6, atol=1e-8,
                       return_stats=True)
    assert_close(ya, yj, atol=EDGE_TOL)
    _counts_close(st, st_j)
    tj, tt = ts_between_edges()
    far_t = t_vcabm(t_hh_rhs, y0, tt, (T_HH_B06, tp), rtol=1e-6, atol=1e-8)
    far_j = j_vcabm(j_hh_rhs, jnp.asarray(Y0), tj, (J_HH_B06, jp),
                    rtol=1e-6, atol=1e-8)
    assert_close(far_t, far_j, atol=FAR_TOL)


def test_vcabm_blowup_sentinel():
    def bad(t, y, a):
        return 50.0 * (1.0 + y ** 2)  # finite-time blow-up

    ts = torch.linspace(0.0, 10.0, 21)
    for solve in (t_vcabm, TV._vcabm_stepwise):
        ys, st = solve(bad, torch.ones(1), ts, None, max_steps=20_000,
                       return_stats=True)
        assert not st.ok
        assert not bool(torch.isfinite(ys[-1]).all())
    yj, st_j = j_vcabm(lambda t, y, a: 50.0 * (1.0 + y ** 2),
                       jnp.ones(1, jnp.float32),
                       jnp.asarray(np_(ts)), None, max_steps=20_000,
                       return_stats=True)
    assert not bool(st_j.ok)


def test_fuzz_vcabm_matches_dopri5_on_random_protocols():
    """tests/test_solver_methods.py's fuzz (its VCABM half), the same
    seeded cases: within 1e-3 of the port's dopri5 at rtol 1e-7; against
    JAX's VCABM 1e-4 at >= 50 ms from an edge, 1e-2 anywhere."""
    rng = np.random.RandomState(11)
    ts = np.linspace(0.0, 4000.0, 401).astype(np.float32)
    far = np.abs(((ts + 250.0) % 500.0) - 250.0) >= 50.0
    y0 = torch.from_numpy(Y0)
    for case in range(3):
        levels = rng.uniform(-120.0, 60.0, 8)
        v_knots = np.repeat(levels, 500).astype(np.float32)
        v_knots = np.append(v_knots, v_knots[-1]).astype(np.float32)
        jp = JP.Protocol(jnp.float32(0.0), jnp.float32(1.0),
                         jnp.asarray(v_knots))
        tp = TP.Protocol(torch.tensor(0.0), torch.tensor(1.0),
                         torch.from_numpy(v_knots))
        pvec = np.array([float(x) for x in J_HH_B06])
        pvec[0::2] *= np.exp(rng.uniform(-0.5, 0.5, 4))
        pvec[1::2] *= np.exp(rng.uniform(-0.1, 0.1, 4))
        jpar = J_HHParams(*[jnp.float32(x) for x in pvec])
        tpar = type(T_HH_B06)(*[np.float32(x) for x in pvec])
        ref = t_odeint(t_hh_rhs, y0, torch.from_numpy(ts), (tpar, tp),
                       rtol=1e-7, atol=1e-9)
        ys = t_vcabm(t_hh_rhs, y0, torch.from_numpy(ts), (tpar, tp),
                     rtol=1e-6, atol=1e-8)
        err = float(torch.max(torch.abs(ys - ref)))
        assert err < 1e-3, (case, err)
        yj = j_vcabm(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts), (jpar, jp),
                     rtol=1e-6, atol=1e-8)
        assert_close(ys, yj, atol=EDGE_TOL)
        assert_close(ys[far], np.asarray(yj)[far], atol=FAR_TOL)


def test_vcabm_blocked_equals_stepwise():
    tp = TP.activation_protocol(20.0, device="cpu")
    ts = torch.linspace(0.0, 8000.0, 801)
    y0 = torch.from_numpy(Y0)
    a = t_vcabm(t_hh_rhs, y0, ts, (T_HH_B06, tp), return_stats=True)
    b = TV._vcabm_stepwise(t_hh_rhs, y0, ts, (T_HH_B06, tp),
                           return_stats=True)
    assert a[1] == b[1] and a[1].ok
    assert torch.equal(a[0], b[0])


def test_vcabm_divided_differences_and_integrals():
    """The Newton tables against numpy: divided differences of a cubic
    (dd[3] = its leading coefficient, dd[4:] = 0 where valid) and the
    basis integrals against exact polynomial integration."""
    rs = np.random.RandomState(3)
    t = np.sort(rs.uniform(-3.0, 0.0, TV.H))[::-1].copy()
    f = (2.0 * t ** 3 - t + 0.5)[:, None]
    dd = TV._divided_diffs(torch.from_numpy(t), torch.from_numpy(f),
                           torch.tensor(6))
    np.testing.assert_allclose(np_(dd)[3, 0], 2.0, rtol=1e-9)
    np.testing.assert_allclose(np_(dd)[4:6, 0], 0.0, atol=1e-8)
    assert np.all(np_(dd)[6:] == 0.0)
    glx = torch.as_tensor(TV._GL_X)
    glw = torch.as_tensor(TV._GL_W)
    got = TV._newton_integrals(torch.tensor(0.0, dtype=torch.float64),
                               torch.tensor(1.0, dtype=torch.float64),
                               torch.from_numpy(t), glx, glw)
    for j in range(TV.H):
        poly = np.poly1d(t[:j], r=True) if j else np.poly1d([1.0])
        want = np.polyint(poly)(1.0) - np.polyint(poly)(0.0)
        np.testing.assert_allclose(float(got[j]), want, rtol=1e-9,
                                   atol=1e-9)
