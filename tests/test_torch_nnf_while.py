"""The plain version of the adaptive while-loop sweep (ops/fused_solve.py::
fused_nnf_solve, one shared net x B protocols) against the Pallas kernel of
ionflux/ops/pallas_solve.py::fused_nnf_solve run with interpret=True, and
against the port's own fixed-trip sweep and odeint.

The two packages run the same algorithm in f32, but XLA:CPU contracts
multiply-adds and rounds exp differently, so their step sequences part at
f32 round-off: the gates agree to 1e-4 away from the protocols' step edges
(``_torch_helpers.ts_between_edges``) and the accepted steps to 5%.  Inside
the port, the while loop and the trip loop share the attempt and the
controller algebra, so on a healthy solve the while loop's records are the
trip loop's accepted trips bit for bit.  Every case that ends the launch
early passes a small max_steps or max_rec: a poisoned lane rejects every
step until max_steps (100,000 by default), in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux.ops import pallas_solve as JK
from ionflux.models import registry as JR
from ionflux_torch import eval as TE
from ionflux_torch import protocols as TP
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.ops import fused_solve as TK

from _torch_helpers import (assert_close, both_families, jax_net, np_,
                            np_net, torch_net, ts_between_edges, ts_grid)

GATE_TOL = 1e-4
ODE_TOL = 2e-2       # the shared controller against per-protocol odeint,
                     # the bound tests/test_pallas.py holds
LEVELS = (-40.0, 20.0)


def _protos(levels=LEVELS, blow_up_at=None):
    """Knot rows [B, N] of activation protocols at dt 1 ms; with
    ``blow_up_at`` (ms) the last row jumps to +5000 mV there, where the
    r-gate's rate overflows f32."""
    pj, _ = both_families("activation_protocol", levels)
    v = np.stack([np.asarray(p.v) for p in pj])
    if blow_up_at is not None:
        v[-1, int(blow_up_at):] = 5000.0
    return jnp.asarray(v, jnp.float32), torch.from_numpy(v)


def _jax_solve(monkeypatch, net, vj, tsj, **kw):
    """ys and n_acc of the reference (its wrapper returns only ys; n_acc is
    read where it enters the reference's phase 2)."""
    seen = {}
    dense = JK._dense_eval

    def spy(rec_sc, rec_y, rec_k, n_acc, ts, b):
        seen["n_acc"] = int(n_acc)
        return dense(rec_sc, rec_y, rec_k, n_acc, ts, b)

    monkeypatch.setattr(JK, "_dense_eval", spy)
    ys = JK.fused_nnf_solve(jax_net(net), JR.HH_B06, vj, tsj, proto_dt=1.0,
                            interpret=True, **kw)
    return np.asarray(ys), seen["n_acc"]


def _port_records(net, vt, tst, **kw):
    """The plain while loop's (rec_sc, rec_y, rec_k, n_out) for the wrapper's
    default tolerances."""
    s = TK._sweep_setup(torch_net(net), TR.HH_B06, vt, tst, 0.0, 1.0,
                        kw.get("t_end"), 1e-5, 1e-7,
                        kw.get("max_rec", 16384), None, block=1)
    return TK._while_solve_plain(s, kw.get("max_steps", 100_000))


def test_while_plain_matches_pallas_interpret_and_odeint(monkeypatch):
    net = np_net(0)
    vj, vt = _protos()
    tsj, tst = ts_between_edges()
    ys_j, n_j = _jax_solve(monkeypatch, net, vj, tsj)
    ys_t = TK.fused_nnf_solve(torch_net(net), TR.HH_B06, vt, tst,
                              proto_dt=1.0)
    assert ys_t.dtype == torch.float32 and tuple(ys_t.shape) == (2, 80, 2)
    assert bool(torch.isfinite(ys_t).all())
    assert_close(ys_t, ys_j, atol=GATE_TOL)
    n_t = int(_port_records(net, vt, tst)[3][0])
    assert n_j > 0 and abs(n_t - n_j) <= 0.05 * n_j
    # the port's own odeint, per protocol, on the reference test's grid
    _, ts = ts_grid(8000.0, 161)
    ys_w = TK.fused_nnf_solve(torch_net(net), TR.HH_B06, vt, ts,
                              proto_dt=1.0, max_rec=4096)
    params = TN.NNfParams(TN.MLP(torch_net(net)), TR.HH_B06)
    _, pt = both_families("activation_protocol", LEVELS)
    ref = torch.stack([TE.solve_states("nnf", params, p, ts, rtol=1e-5,
                                       atol=1e-7) for p in pt])
    assert float((ys_w - ref).abs().max()) < ODE_TOL


def test_while_records_are_the_trip_loops_accepted_trips():
    """Plain while loop vs plain fixed-trip sweep on the same inputs: the
    same attempts, the same controller algebra (sqrt of the max ratio is
    the max of the sqrts) and FSAL, so the while loop's n_acc records equal
    the trip loop's accepted trips bit for bit."""
    net = np_net(0)
    _, vt = _protos()
    tst = ts_between_edges()[1]
    rec_sc, rec_y, rec_k, n_out = _port_records(net, vt, tst)
    n_acc, n_step = n_out.tolist()
    assert 0 < n_acc < n_step
    s = TK._sweep_setup(torch_net(net), TR.HH_B06, vt, tst, 0.0, 1.0, None,
                        1e-5, 1e-7, 2048, None)
    sc, ys, ks, n_ft, _ = TK._trip_solve_plain(s)
    n_valid = int(n_ft[1])
    # a trip was accepted where the next one starts later
    acc = torch.nonzero(sc[1:n_valid, 0] != sc[:n_valid - 1, 0]).flatten()
    assert acc.shape[0] >= n_acc
    acc = acc[:n_acc]
    assert int(acc[-1]) + 1 == n_step    # the same attempts up to t_end
    assert torch.equal(sc[acc], rec_sc[:n_acc])
    assert torch.equal(ys[acc], rec_y[:n_acc])
    assert torch.equal(ks[acc], rec_k[:n_acc])


@pytest.mark.parametrize("case", ["lane blows up", "max_rec exhausted",
                                  "max_steps exhausted"])
def test_while_ends_the_whole_launch_as_inf(monkeypatch, case):
    """No per-lane death: a lane whose rates overflow (a +5000 mV step at
    1000 ms) makes every later step's ratio non-finite, so every step is
    rejected until max_steps and both rows are inf, though 300 steps take
    the healthy rows to t_end = 2000 ms.  Running out of record rows or of
    steps before t_end is the same outcome."""
    net = np_net(0)
    tsj, tst = ts_grid(2000.0, 41)
    kw = dict(t_end=2000.0, max_steps=300)
    if case == "lane blows up":
        healthy = _protos()[1]
        ys_ok = TK.fused_nnf_solve(torch_net(net), TR.HH_B06, healthy, tst,
                                   proto_dt=1.0, **kw)
        assert bool(torch.isfinite(ys_ok).all())
        vj, vt = _protos(blow_up_at=1000.0)
    else:
        vj, vt = _protos()
        kw.update({"max_rec exhausted": dict(max_rec=50),
                   "max_steps exhausted": dict(max_steps=40)}[case])
    ys_j, n_j = _jax_solve(monkeypatch, net, vj, tsj, **kw)
    ys_t = TK.fused_nnf_solve(torch_net(net), TR.HH_B06, vt, tst,
                              proto_dt=1.0, **kw)
    assert np.isinf(ys_j).all() and bool(torch.isinf(ys_t).all())
    n_acc, n_step = _port_records(net, vt, tst, **kw)[3].tolist()
    assert n_acc <= 0 and n_j <= 0
    if case == "max_rec exhausted":
        assert n_acc == n_j == -50
    else:
        assert n_step == kw["max_steps"]


def test_while_wrapper_follows_the_tensors_device():
    """CPU tensors run the plain version: no kernel launch is counted, and
    the result is the plain function's."""
    net = torch_net(np_net(0))
    v = TP.stack([TP.activation_protocol(x, 1.0, device="cpu")
                  for x in LEVELS]).v
    ts = torch.linspace(0.0, 8000.0, 9)
    before = TK.fused_nnf_solve.launches
    ys = TK.fused_nnf_solve(net, TR.HH_B06, v, ts, proto_dt=1.0)
    assert TK.fused_nnf_solve.launches == before
    assert torch.equal(ys, TK.fused_nnf_solve_plain(net, TR.HH_B06, v, ts,
                                                    proto_dt=1.0))
    assert np_(ys).shape == (2, 9, 2)
