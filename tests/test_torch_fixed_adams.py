"""ionflux_torch.solver.odeint_rk4 and odeint_adams against ionflux.

Each test mirrors a JAX oracle test (tests/test_solver.py's RK4 tests,
tests/test_solver_methods.py's Adams tests) case for case, and also holds
the port against the JAX function on the same float32 inputs:

- ``odeint_rk4``: 1e-5 relative (a fixed step sequence: only rounding);
- ``odeint_adams``: gates within 1e-4 at output times >= 50 ms from a
  voltage step edge and 1e-2 anywhere (``ts_between_edges``).  Its
  accepted-step count is held within ADAMS_F32_BAND of JAX's in float32
  and equal in float64.  In float64 the two step sequences are the same
  attempt for attempt; in float32 they agree for the first ~270-300
  attempts on the activation steps and then part where a warm step's Milne
  estimate |y_c - y_p| is one ulp of y or zero (a quasi-steady gate):
  one package doubles the step and the other keeps or halves it, and the
  counts part by up to ~16% (-40 and 0 mV; 5.5% at 20 mV).
- blocked against stepwise: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import protocols as JP
from ionflux.models import hh_rhs as j_hh_core
from ionflux.models.registry import HH_B06 as J_HH_B06
from ionflux.models.registry import HHParams as J_HHParams
from ionflux.solver import odeint as j_odeint
from ionflux.solver import odeint_adams as j_adams
from ionflux.solver import odeint_rk4 as j_rk4
from ionflux_torch import protocols as TP
from ionflux_torch.models import hh_rhs as t_hh_core
from ionflux_torch.models.registry import HH_B06 as T_HH_B06
from ionflux_torch.solver import adams as TA
from ionflux_torch.solver import odeint as t_odeint
from ionflux_torch.solver import odeint_adams as t_adams
from ionflux_torch.solver import odeint_rk4 as t_rk4

from _torch_helpers import assert_close, np_, ts_between_edges


def j_hh_rhs(t, y, args):
    return j_hh_core(args[0], t, y, JP.voltage(args[1], t))


def t_hh_rhs(t, y, args):
    return t_hh_core(args[0], t, y, TP.voltage(args[1], t))


def t_hh_vec_rhs(t, y, args):
    """HH with its 8 parameters a tensor p (differentiable), args = (p,
    protocol): the arithmetic of ``models.hh_rhs``."""
    p, proto = args
    v = TP.voltage(proto, t)
    a, r = y[..., 0], y[..., 1]
    k1 = p[0] * torch.exp(p[1] * v)
    k2 = p[2] * torch.exp(-p[3] * v)
    k3 = p[4] * torch.exp(p[5] * v)
    k4 = p[6] * torch.exp(-p[7] * v)
    return torch.stack([k1 * (1.0 - a) - k2 * a,
                        -k3 * r + k4 * (1.0 - r)], dim=-1)


def assert_grads_close(port, ref) -> None:
    """JAX's adjoint bound (tests/test_solver_methods.py): relative error
    below 1e-3 in norm, elementwise rtol 1e-3 with atol 1e-3 of the
    reference's largest entry."""
    a = np.concatenate([np_(x).astype(np.float64).ravel() for x in port])
    b = np.concatenate([np_(x).astype(np.float64).ravel() for x in ref])
    assert np.isfinite(a).all() and np.linalg.norm(b) > 0
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel < 1e-3, f"relative error {rel:.2e}"
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max())


RK4_RTOL = 1e-5
FAR_TOL, EDGE_TOL = 1e-4, 1e-2
ADAMS_F32_BAND = 0.20
Y0 = np.array([0.0, 1.0], np.float32)


def _both_const(v, dur=5000.0):
    """tests/test_solver.py::constant_protocol in both packages."""
    jp = JP.Protocol(jnp.float32(0.0), jnp.float32(dur),
                     jnp.asarray([v, v], jnp.float32))
    tp = TP.Protocol(torch.tensor(0.0), torch.tensor(dur),
                     torch.tensor([v, v]))
    return jp, tp


def _analytic_hh(t, v, y0):
    p = [np.float64(x) for x in J_HH_B06]
    k1, k2 = p[0] * np.exp(p[1] * v), p[2] * np.exp(-p[3] * v)
    k3, k4 = p[4] * np.exp(p[5] * v), p[6] * np.exp(-p[7] * v)
    a_inf, tau_a = k1 / (k1 + k2), 1.0 / (k1 + k2)
    r_inf, tau_r = k4 / (k3 + k4), 1.0 / (k3 + k4)
    return np.stack([a_inf + (y0[0] - a_inf) * np.exp(-t / tau_a),
                     r_inf + (y0[1] - r_inf) * np.exp(-t / tau_r)], -1)


def test_rk4_matches_analytic():
    jp, tp = _both_const(0.0)
    ts = np.linspace(0.0, 1000.0, 1001).astype(np.float32)
    ys = t_rk4(t_hh_rhs, torch.from_numpy(Y0), torch.from_numpy(ts),
               (T_HH_B06, tp), n_sub=4)
    ref = _analytic_hh(ts.astype(np.float64), 0.0, [0.0, 1.0])
    np.testing.assert_allclose(np_(ys), ref, atol=1e-5)
    yj = j_rk4(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts), (J_HH_B06, jp),
               n_sub=4)
    assert_close(ys, yj, atol=1e-7, rtol=RK4_RTOL)


def test_rk4_is_differentiable():
    """Gradients through RK4 with respect to the HH parameters (and y0):
    finite, p1's non-zero, equal to JAX's within the adjoint tests' bound;
    checkpoint=True equals checkpoint=False bit for bit."""
    jp, tp = _both_const(0.0)
    ts = np.linspace(0.0, 100.0, 101).astype(np.float32)
    pv = np.array([float(x) for x in J_HH_B06], np.float32)

    def loss_j(p):
        ys = j_rk4(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts),
                   (J_HHParams(*p), jp), n_sub=2)
        return jnp.mean(ys[:, 0] ** 2)

    g_j = jax.grad(loss_j)(jnp.asarray(pv))
    out = {}
    for ck in (True, False):
        p = torch.from_numpy(pv).requires_grad_(True)
        y0 = torch.from_numpy(Y0).requires_grad_(True)
        ys = t_rk4(t_hh_vec_rhs, y0, torch.from_numpy(ts), (p, tp), n_sub=2,
                   checkpoint=ck)
        torch.mean(ys[:, 0] ** 2).backward()
        out[ck] = (ys.detach(), p.grad, y0.grad)
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    g = out[True][1]
    assert bool(torch.isfinite(g).all()) and float(g[0].abs()) > 0
    assert_grads_close([g], [g_j])


def test_rk4_differentiates_a_modules_parameters():
    """An nn.Module in args: its parameters get gradients (against a
    closed-form check: d/dW of y(T) for dy/dt = W y on a 1 x 1 system)."""
    lin = torch.nn.Linear(1, 1, bias=False)
    with torch.no_grad():
        lin.weight.fill_(-0.5)

    def rhs(t, y, m):
        return m(y)

    ts = torch.linspace(0.0, 2.0, 5)
    ys = t_rk4(rhs, torch.ones(1), ts, lin, n_sub=32)
    ys[-1, 0].backward()
    # y(T) = exp(wT): dy/dw = T exp(wT)
    np.testing.assert_allclose(float(lin.weight.grad), 2.0 * np.exp(-1.0),
                               rtol=1e-5)


def test_adams_exponential_decay():
    def j_rhs(t, y, a):
        return -y

    def t_rhs(t, y, a):
        return -y

    ts = np.linspace(0.0, 5.0, 11).astype(np.float32)
    ya = t_adams(t_rhs, torch.ones(1), torch.from_numpy(ts), None)
    np.testing.assert_allclose(np_(ya).ravel(), np.exp(-ts), atol=1e-5)
    yj = j_adams(j_rhs, jnp.ones(1, jnp.float32), jnp.asarray(ts), None)
    assert_close(ya, yj, atol=FAR_TOL)


def _counts_close(st_t, st_j, band):
    n_t, n_j = st_t.n_accepted, int(st_j.n_accepted)
    assert abs(n_t - n_j) <= band * n_j, (n_t, n_j)


@pytest.mark.parametrize("level", [-40.0, 20.0])
def test_adams_matches_dopri5_on_step_protocol(level):
    """JAX's case (20 mV) and a second level: the port's Adams within 1e-3
    of its own dopri5 at rtol 1e-7; against JAX's Adams on the gates and in
    accepted steps (module docstring)."""
    jp = JP.activation_protocol(level)
    tp = TP.activation_protocol(level, device="cpu")
    ts = np.linspace(0.0, 8000.0, 801).astype(np.float32)
    y0 = torch.from_numpy(Y0)
    ref = t_odeint(t_hh_rhs, y0, torch.from_numpy(ts), (T_HH_B06, tp),
                   rtol=1e-7, atol=1e-9)
    ya, st = t_adams(t_hh_rhs, y0, torch.from_numpy(ts), (T_HH_B06, tp),
                     rtol=1e-6, atol=1e-8, return_stats=True)
    assert st.ok
    assert float(torch.max(torch.abs(ya - ref))) < 1e-3
    yj, st_j = j_adams(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts),
                       (J_HH_B06, jp), rtol=1e-6, atol=1e-8,
                       return_stats=True)
    assert_close(ya, yj, atol=EDGE_TOL)
    _counts_close(st, st_j, ADAMS_F32_BAND)
    tj, tt = ts_between_edges()
    far_t = t_adams(t_hh_rhs, y0, tt, (T_HH_B06, tp), rtol=1e-6, atol=1e-8)
    far_j = j_adams(j_hh_rhs, jnp.asarray(Y0), tj, (J_HH_B06, jp),
                    rtol=1e-6, atol=1e-8)
    assert_close(far_t, far_j, atol=FAR_TOL)


def test_adams_float64_steps_equal_jax():
    """In float64 the two packages take the same steps: equal accepted and
    attempted counts, states within 1e-9."""
    jp = JP.activation_protocol(20.0)
    jp = JP.Protocol(jnp.float64(jp.t0), jnp.float64(jp.dt),
                     jnp.asarray(jp.v, jnp.float64))
    tp = TP.activation_protocol(20.0, device="cpu")
    tp = TP.Protocol(tp.t0.double(), tp.dt.double(), tp.v.double())
    ts = np.linspace(0.0, 8000.0, 801)
    ya, st = t_adams(t_hh_rhs, torch.tensor([0.0, 1.0], dtype=torch.float64),
                     torch.from_numpy(ts), (T_HH_B06, tp), return_stats=True)
    yj, st_j = j_adams(j_hh_rhs, jnp.asarray([0.0, 1.0], jnp.float64),
                       jnp.asarray(ts), (J_HH_B06, jp), return_stats=True)
    assert st.ok and (st.n_accepted, st.n_steps) == (
        int(st_j.n_accepted), int(st_j.n_steps))
    assert_close(ya, yj, atol=1e-9)


def test_fuzz_adams_matches_dopri5_on_random_protocols():
    """tests/test_solver_methods.py's fuzz (its Adams half): random
    staircases x perturbed HH parameters, within 1e-3 of the port's
    dopri5 at rtol 1e-7, and against JAX's Adams: 1e-4 at output times
    >= 50 ms from a staircase edge, 1e-2 anywhere."""
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
        ys = t_adams(t_hh_rhs, y0, torch.from_numpy(ts), (tpar, tp),
                     rtol=1e-6, atol=1e-8)
        err = float(torch.max(torch.abs(ys - ref)))
        assert err < 1e-3, (case, err)
        yj = j_adams(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts), (jpar, jp),
                     rtol=1e-6, atol=1e-8)
        assert_close(ys, yj, atol=EDGE_TOL)
        assert_close(ys[far], np.asarray(yj)[far], atol=FAR_TOL)


def test_adams_blocked_equals_stepwise():
    """The device-paced loop (blocks of BLOCK_STEPS) against the per-step
    loop: outputs and counts bit for bit, and a blow-up returns inf from
    both."""
    tp = TP.activation_protocol(20.0, device="cpu")
    ts = torch.linspace(0.0, 8000.0, 801)
    y0 = torch.from_numpy(Y0)
    a = t_adams(t_hh_rhs, y0, ts, (T_HH_B06, tp), return_stats=True)
    b = TA._adams_stepwise(t_hh_rhs, y0, ts, (T_HH_B06, tp),
                           return_stats=True)
    assert a[1] == b[1] and a[1].ok
    assert torch.equal(a[0], b[0])

    def bad(t, y, args):
        return 50.0 * (1.0 + y ** 2)

    ts = torch.linspace(0.0, 10.0, 21)
    for solve in (t_adams, TA._adams_stepwise):
        ys, st = solve(bad, torch.ones(1), ts, None, max_steps=2000,
                       return_stats=True)
        assert not st.ok and bool(torch.isinf(ys).all())


def test_adams_agrees_with_jax_dopri5_oracle():
    """JAX's own dopri5 at rtol 1e-7 as a third reference for the port's
    Adams (the oracle of the JAX test, across packages): within 1e-3."""
    jp = JP.activation_protocol(20.0)
    tp = TP.activation_protocol(20.0, device="cpu")
    ts = np.linspace(0.0, 8000.0, 801).astype(np.float32)
    ref = j_odeint(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts),
                   (J_HH_B06, jp), rtol=1e-7, atol=1e-9)
    ya = t_adams(t_hh_rhs, torch.from_numpy(Y0), torch.from_numpy(ts),
                 (T_HH_B06, tp))
    assert float(np.max(np.abs(np_(ya) - np.asarray(ref)))) < 1e-3
