"""ionflux_torch's recorded protocols, Markov ground-truth model and chained
solve against ionflux's: the protocol arrays are equal exactly (both are
numpy from the same constants and assets), the Markov right-hand side
elementwise to f32 round-off, and the chained adaptive solve to 10 x rtol."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import protocols as JP
from ionflux import protorec as JRec
from ionflux.models import markov as JM
from ionflux.models import registry as JR
from ionflux.solver import odeint_chained as j_odeint_chained
from ionflux_torch import protocols as TP
from ionflux_torch import protorec as TRec
from ionflux_torch.models import markov as TM
from ionflux_torch.models import registry as TR
from ionflux_torch.solver import odeint_chained as t_odeint_chained

from _torch_helpers import assert_close, np_

NAMES = ["aps-cell5", "pr3-cell5", "pr4-cell5", "pr5-cell5", "sinewave-cell5"]


def test_available_and_sweeps_match():
    assert TRec.available() == JRec.available() == NAMES
    assert TRec.SWEEPS == JRec.SWEEPS
    assert TRec.DT_MS == JRec.DT_MS
    assert TRec.ASSET_DIR == JRec.ASSET_DIR
    for k in ("PR3", "PR4", "PR5"):
        for suffix in ("TEST_V", "N", "LEAK0", "PERIOD"):
            assert getattr(TRec, f"{k}_{suffix}") == getattr(
                JRec, f"{k}_{suffix}")
    with pytest.raises(FileNotFoundError):
        TRec.load_voltage("pr6-cell5")


@pytest.mark.parametrize("name", NAMES)
def test_load_voltage_and_protocol_equal(name):
    v_t, dt_t = TRec.load_voltage(name)
    v_j, dt_j = JRec.load_voltage(name)
    assert v_t.dtype == v_j.dtype == np.float64
    assert np.array_equal(v_t, v_j) and dt_t == dt_j
    p_t = TRec.protocol(name, device="cpu")
    p_j = JRec.protocol(name)
    assert p_t.v.dtype == torch.float32
    assert np.array_equal(np_(p_t.v), np.asarray(p_j.v))
    assert float(p_t.dt) == float(p_j.dt) and float(p_t.t0) == float(p_j.t0)


def test_from_time_series_refuses_uneven_grids():
    t = np.array([0.0, 0.1, 0.2, 0.35])
    with pytest.raises(ValueError, match="not uniform"):
        TP.from_time_series(t, np.zeros(4), device="cpu")
    p = TP.from_time_series(t[:3] + 5.0, np.arange(3.0), device="cpu")
    q = JP.from_time_series(t[:3] + 5.0, np.arange(3.0))
    assert (float(p.t0), float(p.dt)) == (float(q.t0), float(q.dt))


def test_markov_rhs_and_rates_match():
    rs = np.random.RandomState(0)
    v = rs.uniform(-120.0, 60.0, (64,)).astype(np.float32)
    y = rs.dirichlet(np.ones(6), 64).astype(np.float32)
    rates_t = TM.markov_rates(TR.MARKOV_B06, torch.from_numpy(v))
    rates_j = JM.markov_rates(JR.MARKOV_B06, jnp.asarray(v, jnp.float32))
    for a, b in zip(rates_t, rates_j):
        assert a.dtype == torch.float32
        assert_close(a, b, atol=0.0, rtol=1e-6)
    dy_t = TM.markov_rhs(TR.MARKOV_B06, 0.0, torch.from_numpy(y),
                         torch.from_numpy(v))
    dy_j = JM.markov_rhs(JR.MARKOV_B06, 0.0, jnp.asarray(y, jnp.float32),
                         jnp.asarray(v, jnp.float32))
    assert tuple(dy_t.shape) == (64, 6)
    # each derivative sums products of rates and occupancies of either sign
    scale = float(np.abs(np.asarray(dy_j)).max())
    assert_close(dy_t, dy_j, atol=1e-6 * scale, rtol=1e-6)
    for name in ("MARKOV_Y0_REST", "MARKOV_Y0_INACT"):
        assert np.array_equal(getattr(TM, name), getattr(JM, name))
        assert getattr(TM, name).dtype == np.float32


def _standin_sweeps(seed=0, n_sweeps=3, n=2000):
    """Step sweeps of n knots at 1 ms, each from and back to -80 mV."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(n_sweeps):
        levels = [-80.0, *rs.uniform(-100.0, 50.0, 3), -80.0]
        rows.append(np.repeat(levels, n // 5))
    return np.stack(rows).astype(np.float32)


def test_odeint_chained_markov_matches_reference():
    v = _standin_sweeps()
    # the segment's start and end (the carry is the state at ts[-1]) and
    # times 50 ms from its step edges at multiples of 400 ms, where two
    # adaptive solves agree to 10 x rtol (_torch_helpers.ts_between_edges)
    ts = np.concatenate([[0.0], np.arange(50.0, 2000.0, 100.0),
                         [1999.0]]).astype(np.float32)
    pj = JP.Protocol(jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32),
                     jnp.asarray(v))
    pt = TP.Protocol(torch.zeros(3), torch.ones(3), torch.from_numpy(v))
    ys_j = j_odeint_chained(
        lambda t, y, a: JM.markov_rhs(a[0], t, y, JP.voltage(a[1], t)),
        jnp.asarray(JM.MARKOV_Y0_REST), jnp.asarray(ts), pj, JR.MARKOV_B06)
    ys_t = t_odeint_chained(
        lambda t, y, a: TM.markov_rhs(a[0], t, y, TP.voltage(a[1], t)),
        torch.from_numpy(TM.MARKOV_Y0_REST), torch.from_numpy(ts), pt,
        TR.MARKOV_B06)
    assert tuple(ys_t.shape) == (3, 22, 6) and ys_t.dtype == torch.float32
    assert bool(torch.isfinite(ys_t).all())
    # the state carries over: a sweep starts where the last one ended
    assert torch.equal(ys_t[1, 0], ys_t[0, -1])
    assert_close(ys_t, ys_j, atol=1e-5)
    assert float(ys_t.sum(-1).sub(1.0).abs().max()) < 1e-4


def test_odeint_chained_inf_reaches_every_later_segment():
    """A segment that diverges returns inf and so does every later one."""
    seg = torch.tensor([1.0, float("nan"), 1.0, 1.0])
    ts = torch.linspace(0.0, 1.0, 5)
    ys = t_odeint_chained(lambda t, y, a: -a[1] * y, torch.ones(2), ts, seg)
    assert bool(torch.isfinite(ys[0]).all())
    assert bool(torch.isinf(ys[1:]).all())
    ys_j = j_odeint_chained(lambda t, y, a: -a[1] * y,
                            jnp.ones(2, jnp.float32),
                            jnp.asarray(np_(ts)), jnp.asarray(np_(seg)))
    assert_close(ys, ys_j, atol=1e-5)
