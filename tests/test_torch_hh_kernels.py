"""The plain versions of the HH-population solves (ops/hh_solve.py::
fused_hh_pop_solve_ft and fused_hh_rk4) and of the NN-f population solve
(ops/fused_solve.py::fused_nnf_pop_solve_ft) against the Pallas kernels of
ionflux/ops run with interpret=True, on the shapes of tests/test_pallas.py.

The adaptive solves run the same trip algorithm in f32 but cannot take the
same steps (``_torch_helpers.ts_between_edges`` says why): the gates agree
to 2e-3 everywhere (the bound test_pallas.py holds its kernel to against an
adaptive oracle), to 1e-4 at times 50 ms or more from a voltage step edge,
the executed trips (n_valid) are equal and the accepted steps agree to 5%.
The RK4 solve has no controller, so only exp rounding differs: 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux.models import registry as JR
from ionflux.ops import pallas_rk4 as JRK
from ionflux.ops import pallas_solve as JK
from ionflux_torch import protocols as TP
from ionflux_torch.models import hh_rhs as t_hh_rhs
from ionflux_torch.models import registry as TR
from ionflux_torch.ops import fused_solve as TK
from ionflux_torch.ops import hh_solve as TH
from ionflux_torch.solver import odeint as t_odeint

from _torch_helpers import (assert_close, jax_net, np_, np_net, torch_net,
                            ts_between_edges)

ALL_TOL = 2e-3        # everywhere, edges included
GATE_TOL = 1e-4       # 50 ms or more from a step edge
BASE = np.array([float(x) for x in JR.HH_B06])
ACT_EDGES = (1000.0, 6000.0, 7000.0, 7500.0)   # activation_protocol, ms


def _population(rs, b, sd):
    return (BASE[None] * np.exp(sd * rs.randn(b, 8))).astype(np.float32)


def _activation(v_step=20.0):
    return np.asarray(TP.activation_protocol(v_step, 1.0, device="cpu").v)


def _jax_hh_pop(pop, v, ts, **kw):
    """(ys, n_acc, n_valid) of the Pallas kernel in interpret mode; the
    counts are read off its call of phase 2."""
    seen = {}
    phase2 = JK._dense_eval_ft

    def spy(rec_sc, rec_y, rec_k, n_acc, n_valid, *a, **k):
        seen["n"] = (int(n_acc), int(n_valid))
        return phase2(rec_sc, rec_y, rec_k, n_acc, n_valid, *a, **k)

    JK._dense_eval_ft = spy
    try:
        ys = JK.fused_hh_pop_solve_ft(
            jnp.asarray(pop, jnp.float32), jnp.asarray(v, jnp.float32),
            jnp.asarray(ts, jnp.float32), interpret=True, **kw)
    finally:
        JK._dense_eval_ft = phase2
    return np.asarray(ys), *seen["n"]


def _torch_hh_pop(pop, v, ts, *, proto_dt=1.0, t_end=None, trips=2048,
                  y0=None):
    """The same from the port's plain version (CPU tensors)."""
    ts = torch.from_numpy(np.asarray(ts, np.float32))
    rec_sc, rec_y, rec_k, n_out, alive = TH._hh_pop_solve(
        torch.from_numpy(pop), torch.from_numpy(np.asarray(v, np.float32)),
        None if y0 is None else torch.from_numpy(y0), proto_t0=0.0,
        proto_dt=proto_dt, t_end=float(ts[-1]) if t_end is None else t_end,
        rtol=1e-5, atol=1e-7, trips=trips, plain=True)
    ys = TK._dense_eval_ft(rec_sc, rec_y, rec_k, n_out[0], n_out[1], ts,
                           lane_ok=alive)
    return ys, int(n_out[0]), int(n_out[1]), rec_sc.shape[0]


def _far_from(ts, edges, ms=50.0):
    ts = np.asarray(ts, np.float64)
    return np.all(np.abs(ts[:, None] - np.asarray(edges)[None]) >= ms, axis=1)


def _assert_same_solve(port, ref, ts, edges, steps_rtol=0.05,
                       blocks_apart=0):
    ys_t, acc_t, valid_t, _ = port
    ys_j, acc_j, valid_j = ref
    assert ys_t.dtype == torch.float32
    assert abs(valid_t - valid_j) <= blocks_apart * TK.SWEEP_BLOCK
    if valid_t == valid_j:
        # (trips left in a block after t_end count as accepted 1e-8 steps,
        # so the counts compare only over equal blocks)
        assert abs(acc_t - acc_j) <= steps_rtol * acc_j
    assert_close(ys_t, ys_j, atol=ALL_TOL)
    far = _far_from(ts, edges)
    assert far.sum() > len(far) // 2
    assert_close(ys_t[:, far], ys_j[:, far], atol=GATE_TOL)


# the 161-point grid of test_pallas.py: every 50 ms, the step edges included
TS_ACT = np.linspace(0.0, 8000.0, 161).astype(np.float32)


@pytest.fixture(scope="module")
def healthy():
    """4 perturbed HH_B06 sets on the +20 mV activation protocol, both
    packages (test_pallas.py::test_fused_hh_pop_solve_adaptive)."""
    pop = _population(np.random.RandomState(0), 4, 0.1)
    v = _activation()
    return (pop, v, _torch_hh_pop(pop, v, TS_ACT),
            _jax_hh_pop(pop, v, TS_ACT, proto_dt=1.0, trips=2048))


def test_hh_pop_plain_matches_pallas_interpret(healthy):
    _, _, port, ref = healthy
    assert tuple(port[0].shape) == (4, 161, 2)
    assert bool(torch.isfinite(port[0]).all())
    _assert_same_solve(port, ref, TS_ACT, ACT_EDGES)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hh_pop_plain_matches_pallas_on_staircases(seed):
    """Random 5-level staircases x 20%-lognormal parameter perturbations
    (test_pallas.py::test_fused_hh_pop_solve_fuzz_staircases).  These short
    solves take ~200 accepted steps, ~50 per level, so a reject more or less
    at each edge is already 5%, and a solve that ends near trip 256 may need
    one block more in one package: the counts are held to 10% and one
    block, the gates to the same bounds as everywhere."""
    rng = np.random.RandomState(seed)
    v = np.repeat(rng.uniform(-100, 50, 5), 400).astype(np.float32)
    ts = np.linspace(0.0, 1990.0, 100).astype(np.float32)
    pop = _population(rng, 4, 0.2)
    port = _torch_hh_pop(pop, v, ts, trips=1024, t_end=1990.0)
    ref = _jax_hh_pop(pop, v, ts, proto_dt=1.0, trips=1024, t_end=1990.0)
    assert bool(torch.isfinite(port[0]).all())
    _assert_same_solve(port, ref, ts, (400.0, 800.0, 1200.0, 1600.0),
                       steps_rtol=0.10, blocks_apart=1)


def test_hh_pop_stiff_lane_is_culled_alone(healthy):
    """p2 = 1.0 makes k1 ~ e^20 at +20 mV: the lane pins the shared step and
    the pace cull reaps it alone, with the same finite mask as the Pallas
    kernel; the survivors stay within tolerance of the healthy solve."""
    pop, v, port_ok, _ = healthy
    bad = pop.copy()
    bad[1, 1] = 1.0
    ys_t, _, valid_t, _ = _torch_hh_pop(bad, v, TS_ACT)
    ys_j, _, valid_j = _jax_hh_pop(bad, v, TS_ACT, proto_dt=1.0, trips=2048)
    fin = torch.isfinite(ys_t).all(dim=(1, 2)).tolist()
    assert fin == [True, False, True, True]
    assert fin == list(np.isfinite(ys_j).all(axis=(1, 2)))
    assert bool(torch.isinf(ys_t[1]).all())
    assert valid_t == valid_j
    keep = [0, 2, 3]
    assert_close(ys_t[keep], ys_j[keep], atol=ALL_TOL)
    assert_close(ys_t[keep], port_ok[0][keep], atol=ALL_TOL)


def test_hh_pop_nan_y0_lane_starts_dead(healthy):
    pop, v, _, _ = healthy
    y0 = np.tile(np.array([0.0, 1.0], np.float32), (4, 1))
    y0[2] = np.nan
    ys_t = _torch_hh_pop(pop, v, TS_ACT, y0=y0)[0]
    ys_j = _jax_hh_pop(pop, v, TS_ACT, proto_dt=1.0, trips=2048,
                       y0=jnp.asarray(y0))[0]
    fin = torch.isfinite(ys_t).all(dim=(1, 2)).tolist()
    assert fin == [True, True, False, True]
    assert fin == list(np.isfinite(ys_j).all(axis=(1, 2)))
    assert_close(ys_t, ys_j, atol=ALL_TOL)


def test_hh_pop_trips_shortfall_and_rounding(healthy):
    """512 trips cannot reach t_end: all inf in both packages.  trips is
    rounded up to whole blocks of 256: 1000 runs as 1024."""
    pop, v, port_ok, _ = healthy
    ys_t, acc_t, _, _ = _torch_hh_pop(pop, v, TS_ACT, trips=512)
    ys_j, acc_j, _ = _jax_hh_pop(pop, v, TS_ACT, proto_dt=1.0, trips=512)
    assert acc_t < 0 and acc_j < 0
    assert bool(torch.isinf(ys_t).all()) and bool(np.isinf(ys_j).all())
    ys_1000, _, _, n_rec = _torch_hh_pop(pop, v, TS_ACT, trips=1000)
    assert n_rec == 1024
    ys_1024 = _torch_hh_pop(pop, v, TS_ACT, trips=1024)[0]
    assert bool(torch.isfinite(ys_1000).all())
    assert torch.equal(ys_1000, ys_1024)
    # the early exit at a block end makes the budget irrelevant once reached
    assert torch.equal(ys_1000, port_ok[0])


def test_hh_pop_two_sweep_chain_with_y0_carry(healthy):
    """The d0 objective's chain: a second launch seeded with the first
    launch's final state, against the same chain of Pallas launches."""
    pop, v, port_ok, ref_ok = healthy
    v2 = _activation(-40.0)
    ts2 = np_(ts_between_edges()[1])
    y_t = np_(port_ok[0][:, -1, :]).copy()
    y_j = ref_ok[0][:, -1, :]
    assert_close(y_t, y_j, atol=GATE_TOL)
    ys_t = _torch_hh_pop(pop, v2, ts2, t_end=8000.0, y0=y_t)[0]
    ys_j = _jax_hh_pop(pop, v2, ts2, proto_dt=1.0, trips=2048, t_end=8000.0,
                       y0=jnp.asarray(y_j, jnp.float32))[0]
    assert bool(torch.isfinite(ys_t).all())
    assert_close(ys_t, ys_j, atol=ALL_TOL)
    # the carry matters: from rest the first 50 ms differ
    ys_rest = _torch_hh_pop(pop, v2, ts2, t_end=8000.0)[0]
    assert float((ys_rest[:, 0] - ys_t[:, 0]).abs().max()) > 1e-2


def test_hh_wrappers_refuse_bad_inputs():
    v = torch.from_numpy(_activation())
    ts = torch.tensor([0.0, 8000.0])
    pop = torch.from_numpy(_population(np.random.RandomState(0), 129, 0.1))
    for call in (
            lambda: TH.fused_hh_pop_solve_ft(pop, v, ts, proto_dt=1.0),
            lambda: TH.fused_hh_rk4(pop, v, proto_dt=1.0, dt_out=10.0,
                                    n_out=3),
            lambda: TH.fused_hh_pop_solve_ft(pop[:2, :4], v, ts),
            lambda: TH.fused_hh_pop_solve_ft(pop[:2], v[None], ts),
            lambda: TH.fused_hh_pop_solve_ft(pop[:2], v, ts,
                                             y0=torch.zeros(3, 2)),
            lambda: TH.fused_hh_rk4(pop[:2], v, dt_out=10.0, n_out=0)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError):
        TH.fused_hh_pop_solve_ft(pop[:2].double(), v, ts)
    # CPU tensors take the plain versions: no launch is counted
    before = (TH.fused_hh_pop_solve_ft.launches, TH.fused_hh_rk4.launches)
    TH.fused_hh_rk4(pop[:2], v, proto_dt=1.0, dt_out=10.0, n_out=3)
    assert (TH.fused_hh_pop_solve_ft.launches,
            TH.fused_hh_rk4.launches) == before


def test_hh_rk4_plain_matches_pallas_interpret_and_odeint():
    """test_pallas.py::test_fused_hh_rk4_matches_adaptive's shape: 4 scaled
    HH_B06 sets, 800 output intervals of 10 substeps."""
    pop = np.stack([BASE * (1.0 + 0.05 * i) for i in range(4)]).astype(
        np.float32)
    v = _activation()
    kw = dict(proto_dt=1.0, dt_out=10.0, n_out=801, n_sub=10)
    ys_j = JRK.fused_hh_rk4(jnp.asarray(pop), jnp.asarray(v), interpret=True,
                            **kw)
    ys_t = TH.fused_hh_rk4(torch.from_numpy(pop), torch.from_numpy(v), **kw)
    assert tuple(ys_t.shape) == (4, 801, 2) and ys_t.dtype == torch.float32
    assert torch.equal(ys_t, TH.fused_hh_rk4_plain(
        torch.from_numpy(pop), torch.from_numpy(v), **kw))
    assert_close(ys_t, ys_j, atol=1e-5)
    proto = TP.activation_protocol(20.0, 1.0, device="cpu")
    ts = torch.linspace(0.0, 8000.0, 801)
    for m in range(4):
        ref = t_odeint(
            lambda t, y, a: t_hh_rhs(a, t, y, TP.voltage(proto, t)),
            torch.tensor([0.0, 1.0]), ts, TR.HHParams(*pop[m]))
        assert_close(ys_t[m], ref, atol=ALL_TOL)
    # a shared start state other than rest
    ys0 = TH.fused_hh_rk4(torch.from_numpy(pop), torch.from_numpy(v),
                          proto_dt=1.0, dt_out=10.0, n_out=2, y0=(0.5, 0.25))
    assert ys0[:, 0].tolist() == [[0.5, 0.25]] * 4


# --------------------------------------------------------------------------
# The NN-f population solve: P member nets on ONE shared protocol
# --------------------------------------------------------------------------


def _pop_pair(net):
    v = _activation()
    tsj, tst = ts_between_edges()
    ys_j = JK.fused_nnf_pop_solve_ft(jax_net(net), JR.HH_B06,
                                     jnp.asarray(v), tsj, proto_dt=1.0,
                                     trips=2048, interpret=True)
    ys_t = TK.fused_nnf_pop_solve_ft(torch_net(net), TR.HH_B06,
                                     torch.from_numpy(v), tst, proto_dt=1.0,
                                     trips=2048)
    return ys_t, ys_j


def test_nnf_pop_plain_matches_pallas_interpret():
    """test_pallas.py::test_fused_nnf_pop_solve_matches_batched_lockstep's
    shape: 4 small member nets on the +20 mV activation protocol."""
    ys_t, ys_j = _pop_pair(np_net(1, members=4))
    assert tuple(ys_t.shape) == (4, 80, 2) and ys_t.dtype == torch.float32
    assert bool(torch.isfinite(ys_t).all())
    assert_close(ys_t, ys_j, atol=GATE_TOL)


def test_nnf_pop_divergent_member_is_inf_alone():
    """Member 1's weights x 1e6 send its a-gate non-finite: the lane dies,
    returns inf alone and the others keep their solve
    (test_pallas.py::test_fused_fixed_trip_per_lane_death_pop)."""
    net = np_net(1, members=4)
    for w, _ in net:
        w[1] *= 1e6
    ys_t, ys_j = _pop_pair(net)
    assert bool(torch.isinf(ys_t[1]).all())
    assert bool(torch.isfinite(ys_t[[0, 2, 3]]).all())
    assert_close(ys_t, ys_j, atol=GATE_TOL)


def test_nnf_pop_wrapper_guards():
    net = torch_net(np_net(0, members=2))
    v = torch.from_numpy(_activation())
    ts = torch.tensor([0.0, 8000.0])
    with pytest.raises(ValueError, match="multiple of 256"):
        TK.fused_nnf_pop_solve_ft(net, TR.HH_B06, v, ts, proto_dt=1.0,
                                  trips=1000)
    with pytest.raises(ValueError, match="at most 128"):
        TK.fused_nnf_pop_solve_ft(torch_net(np_net(0, members=129)),
                                  TR.HH_B06, v, ts, proto_dt=1.0, trips=256)
    with pytest.raises(ValueError):
        TK.fused_nnf_pop_solve_ft(net, TR.HH_B06, v[None], ts, trips=256)
    with pytest.raises(ValueError):
        TK.fused_nnf_pop_solve_ft(torch_net(np_net(0)), TR.HH_B06, v, ts,
                                  trips=256)
