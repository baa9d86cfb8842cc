"""ionflux_torch.solver.odeint_adjoint against ionflux.

Each test mirrors an adjoint oracle test of tests/test_solver_methods.py
case for case: the adjoint's gradients against backprop through a fine RK4
in the port (JAX's bound: relative error below 1e-3 in norm, elementwise
rtol 1e-3 with atol 1e-3 of the largest entry), and the port's gradients
against JAX's adjoint on the same float32 inputs (the same bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ionflux import protocols as JP
from ionflux.models import hh_rhs as j_hh_core
from ionflux.models import nnf_rhs as j_nnf_rhs
from ionflux.models.nn import NNfParams as J_NNfParams
from ionflux.models.registry import HH_B06 as J_HH_B06
from ionflux.models.registry import HHParams as J_HHParams
from ionflux.solver import odeint as j_odeint
from ionflux.solver import odeint_adjoint as j_adj
from ionflux_torch import protocols as TP
from ionflux_torch.models import nnf_rhs as t_nnf_rhs
from ionflux_torch.models.nn import NNfParams as T_NNfParams
from ionflux_torch.models.registry import HH_B06 as T_HH_B06
from ionflux_torch.solver import adjoint as TAD
from ionflux_torch.solver import odeint as t_odeint
from ionflux_torch.solver import odeint_adjoint as t_adj
from ionflux_torch.solver import odeint_rk4 as t_rk4

from _torch_helpers import jax_net, np_, np_net, torch_net


def j_hh_rhs(t, y, args):
    return j_hh_core(args[0], t, y, JP.voltage(args[1], t))


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


Y0 = np.array([0.0, 1.0], np.float32)
PV = np.array([float(x) for x in J_HH_B06], np.float32)


def test_adjoint_gradients_match_backprop_through_rk4():
    """dy/dt = A y: the adjoint's gradients in A and y0 against backprop
    through RK4 (n_sub 64), rtol 1e-4 as in JAX's test; and against JAX's
    adjoint (the bound)."""
    a0 = np.array([[-0.3, 0.2], [0.1, -0.5]], np.float32)
    y0 = np.array([1.0, 0.5], np.float32)
    ts = np.linspace(0.0, 5.0, 11).astype(np.float32)

    def fn(t, y, a):
        return a @ y

    out = {}
    for name in ("adj", "rk4"):
        a = torch.from_numpy(a0).requires_grad_(True)
        y = torch.from_numpy(y0).requires_grad_(True)
        if name == "adj":
            ys = t_adj(fn, y, torch.from_numpy(ts), a, 1e-8, 1e-10)
        else:
            ys = t_rk4(fn, y, torch.from_numpy(ts), a, n_sub=64)
        (torch.sum(ys[-1] ** 2) + torch.sum(ys[5] * 0.3)).backward()
        out[name] = (np_(a.grad), np_(y.grad))
    np.testing.assert_allclose(out["adj"][0], out["rk4"][0], rtol=1e-4)
    np.testing.assert_allclose(out["adj"][1], out["rk4"][1], rtol=1e-4)

    def loss_j(a, y):
        ys = j_adj(fn, y, jnp.asarray(ts), a, 1e-8, 1e-10)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[5] * 0.3)

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(a0), jnp.asarray(y0))
    assert_grads_close(out["adj"], g_j)


def _hh_losses(ts, proto_t, proto_j):
    def loss_t(kind):
        p = torch.from_numpy(PV).requires_grad_(True)
        y0 = torch.from_numpy(Y0)
        if kind == "adj":
            ys = t_adj(t_hh_vec_rhs, y0, torch.from_numpy(ts), (p, proto_t),
                       1e-8, 1e-10)
        else:
            ys = t_rk4(t_hh_vec_rhs, y0, torch.from_numpy(ts), (p, proto_t),
                       n_sub=256)
        torch.mean(ys[:, 0] ** 2).backward()
        return p.grad

    def loss_j(pv):
        ys = j_adj(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts),
                   (J_HHParams(*pv), proto_j), 1e-8, 1e-10)
        return jnp.mean(ys[:, 0] ** 2)

    return loss_t, loss_j


def test_adjoint_gradient_through_hh_params():
    """Gradients of a trace loss in the HH parameters through the adaptive
    solver (the adaptive backward branch, seminorm): against backprop
    through RK4 (n_sub 256) and against JAX's adjoint."""
    tp = TP.activation_protocol(0.0, dt_ms=1.0, device="cpu")
    jp = JP.activation_protocol(0.0, dt_ms=1.0)
    ts = np.linspace(0.0, 2000.0, 21).astype(np.float32)
    loss_t, loss_j = _hh_losses(ts, tp, jp)
    g1, g2 = loss_t("adj"), loss_t("rk4")
    assert bool(torch.isfinite(g1).all()) and float(g1[0].abs()) > 0
    np.testing.assert_allclose(np_(g1), np_(g2), rtol=1e-3,
                               atol=1e-3 * float(g2.abs().max()))
    assert_grads_close([g1], [jax.grad(loss_j)(jnp.asarray(PV))])


def test_adjoint_gradient_at_mlp_scale_matches_backprop():
    """A full-width NN-f net (201,801 parameters) puts the augmented state
    past RK4_ABOVE, onto the fixed-step backward branch: its gradient
    against backprop through RK4 (n_sub 128), and against JAX's."""
    net = np_net(0, n_layers=5, n_nodes=200)
    assert sum(w.size + b.size for w, b in net) > TAD.RK4_ABOVE
    tp = TP.activation_protocol(20.0, dt_ms=1.0, device="cpu")
    jp = JP.activation_protocol(20.0, dt_ms=1.0)
    ts = np.linspace(0.0, 500.0, 6).astype(np.float32)
    y0 = np.array([0.1, 0.9], np.float32)

    def t_rhs(t, y, args):
        return t_nnf_rhs(T_NNfParams(args[0], T_HH_B06), t, y,
                         TP.voltage(args[1], t))

    def j_rhs(t, y, args):
        return j_nnf_rhs(J_NNfParams(args[0], J_HH_B06), t, y,
                         JP.voltage(args[1], t))

    grads = {}
    for kind in ("adj", "rk4"):
        layers = [(w.requires_grad_(True), b.requires_grad_(True))
                  for w, b in torch_net(net)]
        y = torch.from_numpy(y0)
        if kind == "adj":
            ys = t_adj(t_rhs, y, torch.from_numpy(ts), (layers, tp), 1e-7,
                       1e-9)
        else:
            ys = t_rk4(t_rhs, y, torch.from_numpy(ts), (layers, tp),
                       n_sub=128)
        (torch.mean(ys[:, 0] ** 2) + 0.3 * torch.mean(ys[:, 1])).backward()
        grads[kind] = [x.grad for pair in layers for x in pair]
    assert_grads_close(grads["adj"], grads["rk4"])

    def loss_j(n):
        ys = j_adj(j_rhs, jnp.asarray(y0), jnp.asarray(ts), (n, jp), 1e-7,
                   1e-9)
        return jnp.mean(ys[:, 0] ** 2) + 0.3 * jnp.mean(ys[:, 1])

    g_j = jax.grad(loss_j)(jax_net(net))
    assert_grads_close(grads["adj"], jax.tree.leaves(g_j))


def test_seminorm_error_weight_reduces_steps():
    """The seminorm odeint the adjoint's backward solves use: error weight
    0 on a pure quadrature lets the controller step at the dynamic
    component's pace; the port's step counts against JAX's."""
    def t_rhs(t, v, args):
        return torch.stack([-0.1 * v[0], v[0]])

    def j_rhs(t, v, args):
        return jnp.stack([-0.1 * v[0], v[0]])

    v0 = np.array([1.0, 0.0], np.float32)
    ts = np.linspace(0.0, 20.0, 5).astype(np.float32)
    w = np.array([1.0, 0.0], np.float32)
    full, st_f = t_odeint(t_rhs, torch.from_numpy(v0), torch.from_numpy(ts),
                          None, return_stats=True)
    semi, st_s = t_odeint(t_rhs, torch.from_numpy(v0), torch.from_numpy(ts),
                          None, error_weight=torch.from_numpy(w),
                          return_stats=True)
    assert st_s.n_steps < st_f.n_steps
    assert float(torch.max(torch.abs(semi[:, 0] - full[:, 0]))) < 1e-5
    assert float(torch.max(torch.abs(semi[:, 1] - full[:, 1]))) < 1e-3
    _, st_j = j_odeint(j_rhs, jnp.asarray(v0), jnp.asarray(ts), None,
                       error_weight=jnp.asarray(w), return_stats=True)
    assert st_s.n_steps == int(st_j.n_steps)


def test_adjoint_seminorm_matches_full_norm_gradients():
    """The default seminorm backward against the full-norm backward (HH
    parameters through a 20 mV step): 1e-3 relative; the seminorm one
    against JAX's."""
    tp = TP.activation_protocol(20.0, dt_ms=1.0, device="cpu")
    jp = JP.activation_protocol(20.0, dt_ms=1.0)
    ts = np.linspace(0.0, 2000.0, 21).astype(np.float32)

    def grad_t(seminorm):
        p = torch.from_numpy(PV).requires_grad_(True)
        ys = t_adj(t_hh_vec_rhs, torch.from_numpy(Y0), torch.from_numpy(ts),
                   (p, tp), 1e-6, 1e-8, 100_000, 4096, seminorm)
        torch.sum(ys[:, 0] ** 2).backward()
        return np_(p.grad)

    g_semi, g_full = grad_t(True), grad_t(False)
    np.testing.assert_allclose(g_semi, g_full, rtol=1e-3, atol=1e-10)

    def loss_j(pv):
        ys = j_adj(j_hh_rhs, jnp.asarray(Y0), jnp.asarray(ts),
                   (J_HHParams(*pv), jp), 1e-6, 1e-8, 100_000, 4096, True)
        return jnp.sum(ys[:, 0] ** 2)

    assert_grads_close([g_semi], [jax.grad(loss_j)(jnp.asarray(PV))])


def test_adjoint_time_and_y0_gradients_match_jax():
    """dL/dts (the boundary terms) and dL/dy0 against JAX's adjoint; the
    forward values equal the port's odeint bit for bit."""
    a0 = np.array([[-0.3, 0.2], [0.1, -0.5]], np.float32)
    y0 = np.array([1.0, 0.5], np.float32)
    ts = np.linspace(0.0, 5.0, 11).astype(np.float32)

    def fn(t, y, a):
        return a @ y

    tt = torch.from_numpy(ts).requires_grad_(True)
    y = torch.from_numpy(y0).requires_grad_(True)
    ys = t_adj(fn, y, tt, torch.from_numpy(a0), 1e-8, 1e-10)
    assert torch.equal(ys.detach(), t_odeint(
        fn, torch.from_numpy(y0), torch.from_numpy(ts), torch.from_numpy(a0),
        rtol=1e-8, atol=1e-10))
    (torch.sum(ys[-1] ** 2) + torch.sum(ys[5] * 0.3)).backward()

    def loss_j(t, yy):
        ys = j_adj(fn, yy, t, jnp.asarray(a0), 1e-8, 1e-10)
        return jnp.sum(ys[-1] ** 2) + jnp.sum(ys[5] * 0.3)

    g_t, g_y = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(ts),
                                                jnp.asarray(y0))
    assert_grads_close([tt.grad, y.grad], [g_t, g_y])


def test_adjoint_differentiates_a_modules_parameters():
    """An nn.Module in args: the adjoint's gradient in its parameters
    against backprop through a fine RK4 of the same module."""
    torch.manual_seed(0)
    mod = torch.nn.Sequential(torch.nn.Linear(2, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 2))

    def fn(t, y, m):
        return m(y) - y

    ts = torch.linspace(0.0, 2.0, 5)
    grads = []
    for adjoint in (True, False):
        mod.zero_grad()
        y0 = torch.tensor([0.3, -0.2])
        ys = (t_adj(fn, y0, ts, mod, 1e-8, 1e-10) if adjoint
              else t_rk4(fn, y0, ts, mod, n_sub=64))
        torch.sum(ys ** 2).backward()
        grads.append([p.grad.clone() for p in mod.parameters()])
    assert_grads_close(grads[0], grads[1])
