"""The device-paced ``odeint`` (blocks of steps, one host read per block)
against the per-step loop it replaced, ``_odeint_stepwise``, on the CPU:
equal bit for bit in the outputs, the accepted and attempted step counts
and the ok flag.  Both loops share the step's arithmetic, so the tolerance
is zero."""

import numpy as np
import pytest
import torch

from ionflux_torch import protocols as TP
from ionflux_torch.eval import _model_rhs, default_y0
from ionflux_torch.models import MARKOV_Y0_REST, hh_rhs, markov_rhs
from ionflux_torch.models import nn as TN
from ionflux_torch.models.registry import HH_B06, HH_D2_BASE, MARKOV_B06
from ionflux_torch.solver import chained as TC
from ionflux_torch.solver import dopri5 as TD
from ionflux_torch.surface import _rhs_r

from _torch_helpers import np_net, torch_net

def _rhs_hh(t, y, a):
    return hh_rhs(a[0], t, y, TP.voltage(a[1], t))


def _rhs_markov(t, y, a):
    return markov_rhs(a[0], t, y, TP.voltage(a[1], t))


def _nan(t, y, a):
    return y * float("nan")   # every attempt fails until the step pins


def _pair(fn, y0, ts, args, **kw):
    got = TD.odeint(fn, y0, ts, args, return_stats=True, **kw)
    want = TD._odeint_stepwise(fn, y0, ts, args, return_stats=True, **kw)
    return got, want


def _same(got, want):
    (ys_g, st_g), (ys_w, st_w) = got, want
    assert st_g == st_w
    assert torch.equal(ys_g, ys_w)


@pytest.mark.parametrize("kind", ["hh", "markov", "nnf", "nnd", "gta",
                                  "rgate"])
def test_blocked_equals_stepwise(kind):
    """A whole solve over an 8 s activation protocol for every right-hand
    side of the port's paths (the five model kinds and the r-gate), each
    ending part way through a block."""
    proto = TP.activation_protocol(20.0, 1.0, device="cpu")
    ts = torch.linspace(0.0, 8000.0, 801)
    net = TN.MLP(torch_net(np_net(3)))
    params = {"hh": HH_B06, "markov": MARKOV_B06, "gta": MARKOV_B06,
              "nnf": TN.NNfParams(net, HH_B06),
              "nnd": TN.NNdParams(net, HH_D2_BASE), "rgate": HH_B06}[kind]
    if kind == "rgate":
        fn, y0 = _rhs_r, torch.ones(1)
    else:
        fn, y0 = _model_rhs(kind), default_y0(kind, device="cpu")
    got, want = _pair(fn, y0, ts, (params, proto))
    _same(got, want)
    stats = got[1]
    assert stats.ok and stats.n_accepted > 100
    assert stats.n_steps % TD.BLOCK_STEPS != 0     # stopped mid-block
    assert torch.isfinite(got[0]).all()


@pytest.mark.parametrize("case", ["max_steps", "buffer_size", "nonfinite"])
def test_dead_solves_equal_stepwise(case):
    """Solves that die: out of steps, out of record slots (the attempt of
    the stopping step lands in the spare slot), a right-hand side that is
    never finite, so the step shrinks until it pins.  Every output inf,
    counts equal."""
    proto = TP.activation_protocol(40.0, 1.0, device="cpu")
    ts = torch.linspace(0.0, 8000.0, 81)
    if case == "max_steps":
        got, want = _pair(_rhs_hh, torch.tensor([0.0, 1.0]), ts,
                          (HH_B06, proto), max_steps=45)
        assert got[1].n_steps == 45
    elif case == "buffer_size":
        got, want = _pair(_rhs_markov, torch.tensor(MARKOV_Y0_REST), ts,
                          (MARKOV_B06, proto), buffer_size=40)
        assert got[1].n_accepted == 40
    else:
        got, want = _pair(_nan, torch.tensor([1.0]),
                          torch.linspace(0.0, 2.0, 5), None)
        assert got[1].n_accepted == 0
    _same(got, want)
    assert not got[1].ok
    assert torch.isinf(got[0]).all()


@pytest.mark.parametrize("option", ["breakpoints", "dt_max", "error_weight"])
def test_options_equal_stepwise(option):
    """The step clamps and the seminorm take the same path in both loops."""
    proto = TP.activation_protocol(-20.0, 1.0, device="cpu")
    ts = torch.linspace(0.0, 8000.0, 401)
    kw = {"breakpoints": torch.tensor([1000.0, 6000.0, 7000.0, 7500.0]),
          "dt_max": 25.0,
          "error_weight": torch.tensor([1.0, 0.0, 1.0, 1.0, 0.5, 2.0])}
    got, want = _pair(_rhs_markov, torch.tensor(MARKOV_Y0_REST), ts,
                      (MARKOV_B06, proto), **{option: kw[option]})
    _same(got, want)
    assert got[1].ok


def test_chained_equals_stepwise(monkeypatch):
    """odeint_chained over two stacked sweeps (state carried across them)
    gives the same traces as the chain of stepwise solves."""
    protos = TP.stack([TP.activation_protocol(v, 1.0, device="cpu")
                       for v in (0.0, 40.0)])
    ts = torch.linspace(0.0, 8000.0, 161)
    y0 = torch.tensor(MARKOV_Y0_REST)
    got = TC.odeint_chained(_rhs_markov, y0, ts, protos, MARKOV_B06)
    monkeypatch.setattr(TC, "odeint", TD._odeint_stepwise)
    want = TC.odeint_chained(_rhs_markov, y0, ts, protos, MARKOV_B06)
    assert got.shape == (2, 161, 6)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    # the chain carried the state: sweep 1 starts where sweep 0 ended
    assert torch.equal(got[1, 0], got[0, -1])
    assert not np.allclose(got[1, 0].numpy(), MARKOV_Y0_REST)
