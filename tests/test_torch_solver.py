"""ionflux_torch.solver.odeint and the dopri5 eval path against ionflux.

On a smooth system the same f32 inputs give the same accepted steps and
states to f32 round-off; on the stiff gate models the two solves part at
round-off and agree to the solve's tolerance.  A blow-up right-hand side
returns all-inf without hanging."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import eval as JE
from ionflux import protocols as JP
from ionflux.models import hh_rhs as j_hh_rhs
from ionflux.models import nn as JN
from ionflux.models import registry as JR
from ionflux.solver import odeint as j_odeint
from ionflux_torch import eval as TE
from ionflux_torch import protocols as TP
from ionflux_torch.models import hh_rhs as t_hh_rhs
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.solver import odeint as t_odeint

from _torch_helpers import (assert_close, jax_net, np_, np_net, torch_net,
                            ts_between_edges, ts_grid)


def _j_proto_rhs(core):
    def rhs(t, y, args):
        return core(args[0], t, y, JP.voltage(args[1], t))
    return rhs


def _t_proto_rhs(core):
    def rhs(t, y, args):
        return core(args[0], t, y, TP.voltage(args[1], t))
    return rhs


J_HH, T_HH = _j_proto_rhs(j_hh_rhs), _t_proto_rhs(t_hh_rhs)
J_NNF, T_NNF = _j_proto_rhs(JN.nnf_rhs), _t_proto_rhs(TN.nnf_rhs)


def _models(kind):
    if kind == "hh":
        return J_HH, T_HH, JR.HH_B06, TR.HH_B06
    net = np_net(0)
    return (J_NNF, T_NNF, JN.NNfParams(jax_net(net), JR.HH_B06),
            TN.NNfParams(TN.MLP(torch_net(net)), TR.HH_B06))


def _j_smooth(t, y, args):
    return jnp.stack([-0.02 * (y[0] - jnp.sin(0.005 * t)),
                      -0.01 * y[1] * y[0] + 0.001])


def _t_smooth(t, y, args):
    return torch.stack([-0.02 * (y[0] - torch.sin(0.005 * t)),
                        -0.01 * y[1] * y[0] + 0.001])


@pytest.mark.parametrize("tol", [(1e-6, 1e-8), (1e-4, 1e-6)])
@pytest.mark.parametrize("option", [None, "breakpoints", "dt_max",
                                    "error_weight"])
def test_odeint_follows_reference_step_for_step(option, tol):
    """On a smooth, non-stiff system the two f32 solves take the same
    accepted steps (the controller, breakpoints, dt_max and the seminorm
    are the same algorithm) and agree to f32 round-off accumulation."""
    bp = np.array([333.3, 1000.0, 1500.5], np.float32)
    w = np.array([1.0, 0.0], np.float32)
    kj = {None: {}, "dt_max": dict(dt_max=20.0),
          "breakpoints": dict(breakpoints=jnp.asarray(bp, jnp.float32)),
          "error_weight": dict(error_weight=jnp.asarray(w, jnp.float32))}
    kt = {None: {}, "dt_max": dict(dt_max=20.0),
          "breakpoints": dict(breakpoints=torch.from_numpy(bp)),
          "error_weight": dict(error_weight=torch.from_numpy(w))}
    tsj, tst = ts_grid(2000.0, 101)
    y0 = np.array([0.0, 1.0], np.float32)
    ys_j, st_j = j_odeint(_j_smooth, jnp.asarray(y0, jnp.float32), tsj,
                          rtol=tol[0], atol=tol[1], return_stats=True,
                          **kj[option])
    ys_t, st_t = t_odeint(_t_smooth, torch.from_numpy(y0), tst, rtol=tol[0],
                          atol=tol[1], return_stats=True, **kt[option])
    assert ys_t.dtype == torch.float32
    assert st_t.ok and bool(st_j.ok)
    assert st_t.n_accepted == int(st_j.n_accepted)
    assert_close(ys_t, ys_j, atol=1e-6, rtol=2e-5)


@pytest.mark.parametrize("kind", ["hh", "nnf"])
@pytest.mark.parametrize("level,tol", [(20.0, (1e-6, 1e-8)),
                                       (-40.0, (1e-5, 1e-7))])
def test_odeint_matches_reference_on_gate_models(kind, level, tol):
    """HH and NN-f on an activation protocol.  The models are stiff enough
    that the step size is held by stability, and DP5's error estimate is a
    sum that cancels to ~1e-6 of its terms, so the two packages' last-bit
    differences (exp, fused multiply-adds) move single accept decisions and
    the step sequences part: n_accepted agrees to 2%, and the states to
    10 x rtol (1e-5 at the default rtol) at times 50 ms or more from the
    protocol's step edges (``_torch_helpers.ts_between_edges``)."""
    jrhs, trhs, jp, tp = _models(kind)
    pj = JP.activation_protocol(level, dt_ms=1.0)
    pt = TP.activation_protocol(level, dt_ms=1.0, device="cpu")
    t = np.concatenate([[0.0], np_(ts_between_edges()[1])]).astype(
        np.float32)
    y0 = np.array([0.0, 1.0], np.float32)
    rtol, atol = tol
    ys_j, st_j = j_odeint(jrhs, jnp.asarray(y0, jnp.float32),
                          jnp.asarray(t, jnp.float32), (jp, pj),
                          rtol=rtol, atol=atol, return_stats=True)
    ys_t, st_t = t_odeint(trhs, torch.from_numpy(y0), torch.from_numpy(t),
                          (tp, pt), rtol=rtol, atol=atol, return_stats=True)
    assert ys_t.dtype == torch.float32
    assert st_t.ok and bool(st_j.ok)
    assert abs(st_t.n_accepted - int(st_j.n_accepted)) <= \
        0.02 * int(st_j.n_accepted)
    assert_close(ys_t, ys_j, atol=10 * rtol)


def test_odeint_blow_up_returns_all_inf():
    """dy/dt = y^2 from y(0) = 1 blows up at t = 1: the solve ends (pinned
    step or step budget) and every output is inf, as in ionflux."""
    def boom(t, y, args):
        return y * y

    ts = torch.linspace(0.0, 2.0, 11)
    ys, st = t_odeint(boom, torch.ones(1), ts, max_steps=2000,
                      return_stats=True)
    assert not st.ok and bool(torch.isinf(ys).all())
    ys_j = j_odeint(lambda t, y, a: y * y, jnp.ones(1, jnp.float32),
                    jnp.linspace(0.0, 2.0, 11, dtype=jnp.float32),
                    max_steps=2000)
    assert bool(jnp.isinf(ys_j).all())
    # a small buffer is a sentinel too, not a truncated trace
    ys_b = t_odeint(T_HH, torch.tensor([0.0, 1.0]), torch.linspace(
        0.0, 8000.0, 11), (TR.HH_B06, TP.activation_protocol(
            20.0, 1.0, device="cpu")), buffer_size=8)
    assert bool(torch.isinf(ys_b).all())


@pytest.mark.parametrize("kind", ["hh", "nnf", "nnd"])
def test_simulate_and_family_match_reference(kind):
    """eval.simulate / simulate_family(backend='xla') currents."""
    net = np_net(1, std=0.05)
    if kind == "hh":
        jp, tp = JR.HH_B06, TR.HH_B06
    elif kind == "nnf":
        jp = JN.NNfParams(jax_net(net), JR.HH_B06)
        tp = TN.NNfParams(TN.MLP(torch_net(net)), TR.HH_B06)
    else:
        jp = JN.NNdParams(jax_net(net), JR.HH_B06)
        tp = TN.NNdParams(TN.MLP(torch_net(net)), TR.HH_B06)
    levels = (-40.0, 20.0)
    pj = [JP.activation_protocol(v, dt_ms=1.0) for v in levels]
    pt = [TP.activation_protocol(v, dt_ms=1.0, device="cpu") for v in levels]
    tsj, tst = ts_grid(8000.0, 161)
    i_j = JE.simulate_family(kind, jp, pj, tsj, JR.SYNTHETIC)
    i_t = TE.simulate_family(kind, tp, pt, tst, TR.SYNTHETIC)
    assert tuple(i_t.shape) == (2, 161)
    assert_close(i_t, i_j, atol=5e-3)
    one = TE.simulate(kind, tp, pt[1], tst, TR.SYNTHETIC)
    assert torch.equal(one, i_t[1])
    ys = TE.solve_states(kind, tp, pt[1], tst)
    assert tuple(ys.shape) == (161, 2)
    assert torch.equal(TE.default_y0(kind, device="cpu"),
                       torch.tensor([0.0, 1.0]))
    # method="adams" (ABM4): the gates against JAX's on the same route,
    # 1e-2 on the grid (its points fall on the step edges), 1e-4 at times
    # >= 50 ms from an edge; the current is the gates' current
    i_a = TE.simulate(kind, tp, pt[1], tst, TR.SYNTHETIC, method="adams")
    ys_a = TE.solve_states(kind, tp, pt[1], tst, method="adams")
    assert torch.equal(i_a, TE._observe(kind, ys_a, TP.voltage(pt[1], tst),
                                        TR.SYNTHETIC))
    assert_close(ys_a, JE.solve_states(kind, jp, pj[1], tsj,
                                       method="adams"), atol=1e-2)
    tfj, tft = ts_between_edges()
    assert_close(TE.solve_states(kind, tp, pt[1], tft, method="adams"),
                 JE.solve_states(kind, jp, pj[1], tfj, method="adams"),
                 atol=1e-4)
    with pytest.raises(ValueError, match="backend"):
        TE.simulate_family(kind, tp, pt, tst, TR.SYNTHETIC, backend="tpu")


def test_entry_runs_on_cpu_when_asked():
    from ionflux_torch.entry import entry

    fn, args = entry(device="cpu")
    params, proto, ts = args
    assert ts.device.type == "cpu" and proto.v.device.type == "cpu"
    cur = fn(*args)
    assert tuple(cur.shape) == (1601,) and bool(torch.isfinite(cur).all())
    assert np.abs(np_(cur)).max() > 0.0


def test_method_flag_sets_the_default_method():
    """scripts/common_torch.py: --method vcabm --device cpu sets
    eval.DEFAULT_METHOD (argument parsing alone; no study runs), which
    solve_states then takes."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import common_torch

    try:
        args = common_torch.parse(common_torch.study_parser("test"),
                                  ["--method", "vcabm", "--device", "cpu"])
        assert args.method == "vcabm" and args.device == "cpu"
        assert TE.DEFAULT_METHOD == "vcabm"
        proto = TP.activation_protocol(20.0, 1.0, device="cpu")
        ts = torch.linspace(0.0, 2000.0, 21)
        from ionflux_torch.solver import odeint_vcabm

        assert torch.equal(TE.solve_states("hh", TR.HH_B06, proto, ts),
                           odeint_vcabm(T_HH, TE.default_y0("hh", device="cpu"),
                                        ts, (TR.HH_B06, proto)))
    finally:
        TE.DEFAULT_METHOD = "dopri5"
