"""ionflux_torch.solver.odeint_rosenbrock against ionflux.

Each test mirrors a tests/test_implicit.py case (oracles: scipy solve_ivp
at 1e-11 in float64 on the same vector field) and also holds the port
against JAX's ``odeint_rosenbrock`` on the same inputs: gates within 1e-4
at output times >= 50 ms from a voltage step edge and 1e-2 anywhere, and
the accepted steps within 5%.  The Markov-staircase case runs in float64
(as the JAX test does under x64).  The port's Jacobians come from
``torch.func.jacrev`` and its solves from one ``lu_factor_ex`` (module
docstring); blocked against stepwise: bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import torch
from scipy.integrate import solve_ivp

from ionflux import eval as JE
from ionflux import protocols as JP
from ionflux.models import hh_rhs as j_hh_core
from ionflux.models import markov_rhs as j_markov_rhs
from ionflux.models.registry import HH_B06 as J_HH_B06
from ionflux.models.registry import MARKOV_B06 as J_MARKOV_B06
from ionflux.models.registry import SYNTHETIC as J_SYN
from ionflux.solver import odeint_rosenbrock as j_ros
from ionflux_torch import eval as TE
from ionflux_torch import protocols as TP
from ionflux_torch.models import hh_rhs as t_hh_core
from ionflux_torch.models import MARKOV_Y0_REST
from ionflux_torch.models import markov_rhs as t_markov_rhs
from ionflux_torch.models.registry import HH_B06 as T_HH_B06
from ionflux_torch.models.registry import MARKOV_B06 as T_MARKOV_B06
from ionflux_torch.models.registry import SYNTHETIC as T_SYN
from ionflux_torch.solver import implicit as TI
from ionflux_torch.solver import odeint as t_odeint
from ionflux_torch.solver import odeint_rosenbrock as t_ros

from _torch_helpers import assert_close, np_, ts_between_edges


def j_hh_rhs(t, y, args):
    return j_hh_core(args[0], t, y, JP.voltage(args[1], t))


def t_hh_rhs(t, y, args):
    return t_hh_core(args[0], t, y, TP.voltage(args[1], t))


FAR_TOL, EDGE_TOL = 1e-4, 1e-2
ROS_BAND = 0.05
Y0 = np.array([0.0, 1.0], np.float32)


def _counts_close(st_t, st_j, band=ROS_BAND):
    n_t, n_j = st_t.n_accepted, int(st_j.n_accepted)
    assert abs(n_t - n_j) <= band * n_j, (n_t, n_j)


def _hh_np(proto_np):
    knot_t, knot_v = proto_np
    p = [float(x) for x in J_HH_B06]

    def rhs_np(t, y):
        v = np.interp(t, knot_t, knot_v)
        k1 = p[0] * np.exp(p[1] * v)
        k2 = p[2] * np.exp(-p[3] * v)
        k3 = p[4] * np.exp(p[5] * v)
        k4 = p[6] * np.exp(-p[7] * v)
        return [k1 * (1 - y[0]) - k2 * y[0], -k3 * y[1] + k4 * (1 - y[1])]
    return rhs_np


def test_rosenbrock_exponential_decay():
    ts = np.linspace(0.0, 5.0, 11).astype(np.float32)
    ys, st = t_ros(lambda t, y, a: -y, torch.ones(1), torch.from_numpy(ts),
                   None, return_stats=True)
    assert st.ok
    np.testing.assert_allclose(np_(ys).ravel(), np.exp(-ts), atol=2e-5)
    yj, st_j = j_ros(lambda t, y, a: -y, jnp.ones(1, jnp.float32),
                     jnp.asarray(ts), None, return_stats=True)
    assert_close(ys, yj, atol=FAR_TOL)
    _counts_close(st, st_j)


def test_rosenbrock_stiff_step_count_beats_dopri5():
    """Prothero-Robinson, lam = -1e4: the L-stable pair tracks cos t with
    accuracy-limited steps, an order of magnitude fewer than dopri5."""
    lam = -1e4

    def t_rhs(t, y, a):
        return lam * (y - torch.cos(t)) - torch.sin(t)

    def j_rhs(t, y, a):
        return lam * (y - jnp.cos(t)) - jnp.sin(t)

    ts = np.linspace(0.0, 1.0, 11).astype(np.float32)
    ys_r, st_r = t_ros(t_rhs, torch.ones(1), torch.from_numpy(ts), None,
                       rtol=1e-5, atol=1e-7, return_stats=True)
    _, st_e = t_odeint(t_rhs, torch.ones(1), torch.from_numpy(ts), None,
                       rtol=1e-5, atol=1e-7, buffer_size=8192,
                       return_stats=True)
    assert st_r.ok and st_e.ok
    np.testing.assert_allclose(np_(ys_r).ravel(),
                               np.cos(ts.astype(np.float64)), atol=2e-4)
    assert st_r.n_steps * 10 < st_e.n_steps, (st_r.n_steps, st_e.n_steps)
    yj, st_j = j_ros(j_rhs, jnp.ones(1, jnp.float32), jnp.asarray(ts), None,
                     rtol=1e-5, atol=1e-7, return_stats=True)
    assert_close(ys_r, yj, atol=FAR_TOL)
    _counts_close(st_r, st_j)


def test_rosenbrock_hh_step_protocol_matches_f64_oracle():
    """The time Jacobian through the piecewise-linear voltage drive: within
    3e-4 of scipy; against JAX on the gates and in accepted steps."""
    jp = JP.activation_protocol(20.0)
    tp = TP.activation_protocol(20.0, device="cpu")
    ts64 = np.linspace(0.0, 8000.0, 2001)
    ys, st = t_ros(t_hh_rhs, torch.from_numpy(Y0),
                   torch.from_numpy(ts64.astype(np.float32)), (T_HH_B06, tp),
                   rtol=1e-6, atol=1e-8, return_stats=True)
    assert st.ok
    proto_np = (np_(tp.times()).astype(np.float64),
                np_(tp.v).astype(np.float64))
    sol = solve_ivp(_hh_np(proto_np), (0.0, 8000.0), [0.0, 1.0], t_eval=ts64,
                    rtol=1e-11, atol=1e-13, method="RK45", max_step=100.0)
    assert np.max(np.abs(np_(ys).astype(np.float64) - sol.y.T)) < 3e-4
    yj, st_j = j_ros(j_hh_rhs, jnp.asarray(Y0),
                     jnp.asarray(ts64, jnp.float32), (J_HH_B06, jp),
                     rtol=1e-6, atol=1e-8, return_stats=True)
    assert_close(ys, yj, atol=EDGE_TOL)
    _counts_close(st, st_j)
    tj, tt = ts_between_edges()
    far_t = t_ros(t_hh_rhs, torch.from_numpy(Y0), tt, (T_HH_B06, tp),
                  rtol=1e-6, atol=1e-8)
    far_j = j_ros(j_hh_rhs, jnp.asarray(Y0), tj, (J_HH_B06, jp), rtol=1e-6,
                  atol=1e-8)
    assert_close(far_t, far_j, atol=FAR_TOL)


def test_rosenbrock_markov_staircase_matches_radau_oracle():
    """The 6-state Markov ground truth on the staircase in float64 against
    scipy's Radau at 1e-11 (5e-4) and JAX's solve (1e-4: the step sequences
    part at float64 round-off), probability kept (1e-3)."""
    jp = JP.staircase_protocol()
    tp = TP.staircase_protocol(device="cpu")
    t_end = float(np_(tp.times())[-1])
    ts64 = np.linspace(0.0, t_end, 1001)
    tp64 = TP.Protocol(tp.t0.double(), tp.dt.double(), tp.v.double())
    ys, st = t_ros(lambda t, y, a: t_markov_rhs(a[0], t, y,
                                                TP.voltage(a[1], t)),
                   torch.tensor(MARKOV_Y0_REST, dtype=torch.float64),
                   torch.from_numpy(ts64), (T_MARKOV_B06, tp64), rtol=1e-5,
                   atol=1e-7, buffer_size=8192, return_stats=True)
    assert st.ok
    knot_t = np_(tp.times()).astype(np.float64)
    knot_v = np_(tp.v).astype(np.float64)
    p = [float(x) for x in J_MARKOV_B06]

    def rhs_np(t, y):
        v = np.interp(t, knot_t, knot_v)
        a1 = p[0] * np.exp(p[1] * v)
        b1 = p[2] * np.exp(-p[3] * v)
        bh = p[4] * np.exp(p[5] * v)
        ah = p[6] * np.exp(-p[7] * v)
        a2 = p[8] * np.exp(p[9] * v)
        b2 = p[10] * np.exp(-p[11] * v)
        c1, c2, i, ic1, ic2, o = y
        return [a1 * c2 + ah * ic1 + b2 * o - (b1 + bh + a2) * c1,
                b1 * c1 + ah * ic2 - (a1 + bh) * c2,
                a2 * ic1 + bh * o - (b2 + ah) * i,
                a1 * ic2 + bh * c1 + b2 * i - (b1 + ah + a2) * ic1,
                b1 * ic1 + bh * c2 - (ah + a1) * ic2,
                a2 * c1 + ah * i - (b2 + bh) * o]

    sol = solve_ivp(rhs_np, (0.0, t_end), [0.0, 1.0, 0.0, 0.0, 0.0, 0.0],
                    t_eval=ts64, rtol=1e-11, atol=1e-13, method="Radau")
    assert np.max(np.abs(np_(ys) - sol.y.T)) < 5e-4
    np.testing.assert_allclose(np_(ys).sum(-1), 1.0, atol=1e-3)
    yj, st_j = j_ros(lambda t, y, a: j_markov_rhs(a[0], t, y,
                                                  JP.voltage(a[1], t)),
                     jnp.asarray(np.asarray(MARKOV_Y0_REST, np.float64)),
                     jnp.asarray(ts64), (J_MARKOV_B06, jp), rtol=1e-5,
                     atol=1e-7, buffer_size=8192, return_stats=True)
    assert_close(ys, yj, atol=FAR_TOL)
    _counts_close(st, st_j)


def test_rosenbrock_failure_sentinel_returns_inf():
    def blowup(t, y, args):
        return y * y * 1e3 + 1.0

    ts = torch.linspace(0.0, 100.0, 11)
    for solve in (t_ros, TI._rosenbrock_stepwise):
        ys, st = solve(blowup, torch.ones(1), ts, None, max_steps=2000,
                       return_stats=True)
        assert not st.ok
        assert bool(torch.isinf(ys).all())
    _, st_j = j_ros(lambda t, y, a: y * y * 1e3 + 1.0,
                    jnp.ones(1, jnp.float32), jnp.asarray(np_(ts)), None,
                    max_steps=2000, return_stats=True)
    assert not bool(st_j.ok)


def test_rosenbrock_parameter_lanes_fail_alone():
    """JAX's vmapped lanes as separate solves (the port has no vmap of the
    step loop): a diverging lane returns inf and its neighbours match
    scipy."""
    def rhs(t, y, k):
        return k * y * (1.0 - y) - torch.where(k > 50.0, -y * y * 1e3,
                                               torch.zeros_like(y))

    ts = np.linspace(0.0, 2.0, 9).astype(np.float32)
    for k in (1.0, 2.0, 100.0):
        ys = np_(t_ros(rhs, torch.tensor([0.5]), torch.from_numpy(ts),
                       torch.tensor(k), max_steps=3000))
        if k > 50.0:
            assert np.all(np.isinf(ys))
            continue
        sol = solve_ivp(lambda t, y: k * y * (1 - y), (0, 2.0), [0.5],
                        t_eval=ts.astype(np.float64), rtol=1e-11,
                        atol=1e-13)
        np.testing.assert_allclose(ys.ravel(), sol.y[0], atol=2e-4)


def test_rosenbrock_via_simulate_method_flag():
    """method='rosenbrock' through eval.simulate: within 2e-3 of dopri5's
    current, and against JAX's simulate on the same route."""
    tp = TP.activation_protocol(0.0, device="cpu")
    ts = np.linspace(0.0, 8000.0, 801).astype(np.float32)
    kw = dict(rtol=1e-6, atol=1e-8)
    c_ref = TE.simulate("hh", T_HH_B06, tp, torch.from_numpy(ts), T_SYN, **kw)
    c_ros = TE.simulate("hh", T_HH_B06, tp, torch.from_numpy(ts), T_SYN,
                        method="rosenbrock", **kw)
    assert float(torch.max(torch.abs(c_ref - c_ros))) < 2e-3
    c_j = JE.simulate("hh", J_HH_B06, JP.activation_protocol(0.0),
                      jnp.asarray(ts), J_SYN, method="rosenbrock", **kw)
    assert_close(c_ros, c_j, atol=EDGE_TOL)


def test_rosenbrock_blocked_equals_stepwise_with_breakpoints():
    """Blocked against stepwise bit for bit, with breakpoints at the step
    edges and a dt_max; the breakpoints change the result by no more than
    the tolerance (JAX's odeint test's bound)."""
    tp = TP.activation_protocol(40.0, device="cpu")
    ts = torch.linspace(0.0, 8000.0, 801)
    y0 = torch.from_numpy(Y0)
    bps = torch.tensor([1000.0, 6000.0, 7000.0, 7500.0])
    kw = dict(breakpoints=bps, dt_max=200.0, return_stats=True)
    a = t_ros(t_hh_rhs, y0, ts, (T_HH_B06, tp), **kw)
    b = TI._rosenbrock_stepwise(t_hh_rhs, y0, ts, (T_HH_B06, tp), **kw)
    assert a[1] == b[1] and a[1].ok
    assert torch.equal(a[0], b[0])
    plain = t_ros(t_hh_rhs, y0, ts, (T_HH_B06, tp))
    np.testing.assert_allclose(np_(a[0]), np_(plain), atol=5e-4)


def test_lu_solves_match_linalg_solve():
    """The step's three solves through one lu_factor_ex against
    torch.linalg.solve on 2 x 2 to 6 x 6 systems (one needs a row swap),
    and a singular matrix gives non-finite values, not an error."""
    rs = np.random.RandomState(0)
    for n in range(2, 7):
        a = torch.from_numpy(rs.randn(n, n))
        a[0, 0] = 1e-12
        b = torch.from_numpy(rs.randn(n))
        lu, piv, _ = torch.linalg.lu_factor_ex(a, check_errors=False)
        np.testing.assert_allclose(np_(TI._solve(lu, piv, b)),
                                   np_(torch.linalg.solve(a, b)),
                                   rtol=1e-9, atol=1e-12)
    lu, piv, info = torch.linalg.lu_factor_ex(torch.zeros(3, 3),
                                              check_errors=False)
    assert int(info) > 0
    assert not bool(torch.isfinite(TI._solve(lu, piv, torch.ones(3))).all())
