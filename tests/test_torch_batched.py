"""ionflux_torch.solver.batched (the lockstep odeint_batched, device-paced in
blocks) against ionflux.solver.batched on a population of HH candidates
over a step protocol, and the blocked loop against its per-step reference
``_odeint_batched_stepwise`` bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import protocols as JP
from ionflux.models.registry import HH_B06
from ionflux.solver import batched as JB
from ionflux_torch import protocols as TP
from ionflux_torch.solver import batched as TB

from _torch_helpers import assert_close, np_, ts_between_edges, ts_grid

EDGE_FAR_TOL = 3e-5   # gates 50 ms or more from a step edge (rtol 1e-6,
                      # atol 1e-8): the two f32 step sequences part at
                      # round-off (FMA, exp), and only where a step
                      # straddles an edge does that show
EDGE_TOL = 1e-2       # anywhere, at the edges included (_torch_helpers)
NACC_RTOL = 0.05      # accepted steps of the two controllers


def _params(b: int, seed: int = 0) -> np.ndarray:
    base = np.array([float(x) for x in HH_B06])
    rs = np.random.RandomState(seed)
    return (base[None] * np.exp(0.1 * rs.randn(b, 8))).astype(np.float32)


def _rhs_j(t, y, args):
    ps, proto = args
    v = JP.voltage(proto, t)
    k1 = ps[:, 0] * jnp.exp(ps[:, 1] * v)
    k2 = ps[:, 2] * jnp.exp(-ps[:, 3] * v)
    k3 = ps[:, 4] * jnp.exp(ps[:, 5] * v)
    k4 = ps[:, 6] * jnp.exp(-ps[:, 7] * v)
    return jnp.stack([k1 * (1.0 - y[:, 0]) - k2 * y[:, 0],
                      -k3 * y[:, 1] + k4 * (1.0 - y[:, 1])], axis=-1)


def _rhs_t(t, y, args):
    ps, proto = args
    v = TP.voltage(proto, t)
    k1 = ps[:, 0] * torch.exp(ps[:, 1] * v)
    k2 = ps[:, 2] * torch.exp(-ps[:, 3] * v)
    k3 = ps[:, 4] * torch.exp(ps[:, 5] * v)
    k4 = ps[:, 6] * torch.exp(-ps[:, 7] * v)
    return torch.stack([k1 * (1.0 - y[:, 0]) - k2 * y[:, 0],
                        -k3 * y[:, 1] + k4 * (1.0 - y[:, 1])], dim=-1)


def _protocols(v_step=20.0):
    return (JP.activation_protocol(v_step, dt_ms=1.0),
            TP.activation_protocol(v_step, 1.0, device="cpu"))


def _y0(b):
    y0 = np.tile(np.array([0.0, 1.0], np.float32), (b, 1))
    return jnp.asarray(y0), torch.from_numpy(y0)


def _both(ps, ts, y0=None, **kw):
    pj, pt = _protocols()
    tj, tt = ts
    yj, yt = _y0(ps.shape[0]) if y0 is None else (jnp.asarray(y0),
                                                  torch.from_numpy(y0))
    kw = dict(rtol=1e-6, atol=1e-8, return_stats=True, **kw)
    got = TB.odeint_batched(_rhs_t, yt, tt, (torch.from_numpy(ps), pt), **kw)
    want = JB.odeint_batched(_rhs_j, yj, tj, (jnp.asarray(ps), pj), **kw)
    return got, want


def _check_stats(got, want):
    (_, st_t), (_, st_j) = got, want
    assert np.array_equal(np_(st_t.ok), np.asarray(st_j.ok))
    assert abs(st_t.n_accepted - int(st_j.n_accepted)) <= NACC_RTOL * int(
        st_j.n_accepted)


def test_batched_matches_jax_away_from_edges():
    ps = _params(4)
    got, want = _both(ps, ts_between_edges(8000.0, 100.0))
    assert_close(got[0], want[0], atol=EDGE_FAR_TOL)
    _check_stats(got, want)
    assert bool(got[1].ok.all())


def test_batched_matches_jax_at_edges():
    ps = _params(3, seed=1)
    got, want = _both(ps, ts_grid(8000.0, 801))
    assert_close(got[0], want[0], atol=EDGE_TOL)
    _check_stats(got, want)


def test_dead_lane_returns_inf_alone():
    ps = _params(3, seed=2)
    y0 = np.tile(np.array([0.0, 1.0], np.float32), (3, 1))
    y0[1, 0] = np.nan
    got, want = _both(ps, ts_between_edges(8000.0, 100.0), y0=y0)
    ys_t, ys_j = np_(got[0]), np.asarray(want[0])
    assert np.isinf(ys_t[1]).all() and np.isinf(ys_j[1]).all()
    assert_close(got[0], want[0], atol=EDGE_FAR_TOL)
    assert np_(got[1].ok).tolist() == [True, False, True]
    _check_stats(got, want)


@pytest.mark.parametrize("stop", [dict(max_steps=40), dict(buffer_size=12)])
def test_step_and_buffer_stops(stop):
    """A solve cut by max_steps or a full record buffer: every lane inf, the
    counts where the stop left them, in both packages."""
    ps = _params(3, seed=3)
    got, want = _both(ps, ts_grid(8000.0, 81), **stop)
    assert np.isinf(np_(got[0])).all() and np.isinf(np.asarray(want[0])).all()
    assert not bool(got[1].ok.any())
    assert got[1].n_steps == int(want[1].n_steps)
    # a borderline accept can flip at round-off
    assert abs(got[1].n_accepted - int(want[1].n_accepted)) <= 1
    if "max_steps" in stop:
        assert got[1].n_steps == 40
    else:
        assert got[1].n_accepted == 12


def test_sleep_matches_jax():
    """sleep_tol = 0.1 with sleep_h_max: a settled component freezes on a
    threshold, so in f32 the round-off that parts the two step sequences
    also flips freeze decisions and the step counts drift apart (~18% here);
    in float64 the two packages keep together: gates within 1e-5, accepted
    steps within 1%, and fewer steps than without sleeping."""
    ps = _params(4, seed=4).astype(np.float64)
    pj, pt = _protocols()
    pj = type(pj)(*[jnp.asarray(x, jnp.float64) for x in pj])
    pt = type(pt)(*[x.double() for x in pt])
    ts = np.arange(50.0, 8000.0, 100.0)
    y0 = np.tile([0.0, 1.0], (4, 1))
    out = []
    for kw in (dict(sleep_tol=0.1, sleep_h_max=50.0), {}):
        kw.update(rtol=1e-6, atol=1e-8, return_stats=True)
        out.append((
            TB.odeint_batched(_rhs_t, torch.tensor(y0), torch.tensor(ts),
                              (torch.tensor(ps), pt), **kw),
            JB.odeint_batched(_rhs_j, jnp.asarray(y0), jnp.asarray(ts),
                              (jnp.asarray(ps), pj), **kw)))
    (got, want), (awake, _) = out
    assert_close(got[0], want[0], atol=1e-5)
    assert np.array_equal(np_(got[1].ok), np.asarray(want[1].ok))
    assert abs(got[1].n_accepted - int(want[1].n_accepted)) <= 0.01 * int(
        want[1].n_accepted)
    assert got[1].n_steps < awake[1].n_steps


def test_chunked_sort_lanes_in_callers_order():
    """B = 6 lanes in chunks of 4, sorted by the stiffness proxy: the same
    chunks in both packages (each chunk's controller sets its steps), the
    results in the caller's order."""
    ps = _params(6, seed=5)
    ps[2, 0] *= 30.0           # a stiff lane, sorted to the end
    pj, pt = _protocols()
    tj, tt = ts_between_edges(8000.0, 100.0)
    yj, yt = _y0(6)
    kw = dict(rtol=1e-6, atol=1e-8, max_lanes=4, sort_lanes=True,
              return_stats=True)
    ys_t, st_t = TB.odeint_batched_chunked(
        _rhs_t, yt, tt, (torch.from_numpy(ps), pt), **kw)
    ys_j, st_j = JB.odeint_batched_chunked(
        _rhs_j, yj, tj, (jnp.asarray(ps), pj), **kw)
    assert tuple(ys_t.shape) == (6, tt.shape[0], 2)
    assert_close(ys_t, ys_j, atol=EDGE_FAR_TOL)
    assert np.array_equal(np_(st_t.ok), np.asarray(st_j.ok))
    # each lane is the lane the caller passed: lane 2 solved alone agrees
    alone = TB.odeint_batched(_rhs_t, yt[2:3], tt,
                              (torch.from_numpy(ps[2:3]), pt), rtol=1e-6,
                              atol=1e-8)
    assert_close(ys_t[2:3], alone, atol=EDGE_FAR_TOL)
    # without sort_lanes, and with an explicit lane_leaf
    ys_u = TB.odeint_batched_chunked(
        _rhs_t, yt, tt, (torch.from_numpy(ps), pt), rtol=1e-6, atol=1e-8,
        max_lanes=4,
        lane_leaf=lambda x: isinstance(x, torch.Tensor) and x.shape[0] == 6)
    assert_close(ys_u, ys_t, atol=EDGE_FAR_TOL)


def _stepwise_pair(ps, y0, ts, **kw):
    pt = TP.activation_protocol(20.0, 1.0, device="cpu")
    args = (torch.from_numpy(ps), pt)
    kw = dict(rtol=1e-5, atol=1e-7, return_stats=True, **kw)
    got = TB.odeint_batched(_rhs_t, torch.from_numpy(y0), ts, args, **kw)
    want = TB._odeint_batched_stepwise(_rhs_t, torch.from_numpy(y0), ts,
                                       args, **kw)
    return got, want


@pytest.mark.parametrize("case", ["plain", "dead_lane", "max_steps",
                                  "buffer", "sleep"])
def test_blocked_equals_stepwise(case):
    """The blocked loop (BLOCK_STEPS steps between host reads, a stopped
    solve's steps masked) against the per-step loop: outputs, ok flags and
    counts equal bit for bit; every case stops part way through a block."""
    ps = _params(3, seed=6)
    y0 = np.tile(np.array([0.0, 1.0], np.float32), (3, 1))
    kw = {}
    if case == "dead_lane":
        y0[0, 1] = np.inf
    elif case == "max_steps":
        kw = dict(max_steps=45)
    elif case == "buffer":
        kw = dict(buffer_size=50)
    elif case == "sleep":
        kw = dict(sleep_tol=0.1, sleep_h_max=50.0)
    ts = torch.linspace(0.0, 8000.0, 801)
    (ys_g, st_g), (ys_w, st_w) = _stepwise_pair(ps, y0, ts, **kw)
    assert st_g.n_steps % TB.BLOCK_STEPS != 0
    assert (st_g.n_accepted, st_g.n_steps) == (st_w.n_accepted, st_w.n_steps)
    assert torch.equal(st_g.ok, st_w.ok)
    assert torch.equal(ys_g, ys_w)
