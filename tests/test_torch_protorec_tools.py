"""The port's protocol-reconstruction tools (ionflux_torch/protorec.py)
against the JAX package's (ionflux/protorec.py): the numpy tools exact on
numpy-seeded traces, ``fit_voltage`` (autograd RK4 and Adam under a cosine
schedule in the port, ``lax.scan`` and optax in JAX) at 160 samples in
float64, and ``save_asset`` into a temporary ASSET_DIR."""

import numpy as np
import pytest
import torch

from ionflux import protorec as JRec
from ionflux.models.registry import HH_D0_FIT as J_HH
from ionflux.models.registry import TABLE1 as J_TABLE1
from ionflux_torch import protorec as TRec
from ionflux_torch.models import registry as TReg


def _gta_trace(n: int = 2000, seed: int = 0):
    """(v, a, u) of the 2nd-order a-gate on a step protocol by a fine
    explicit integration (numpy), v with a few numpy-seeded levels."""
    rs = np.random.RandomState(seed)
    levels = rs.uniform(-100.0, 40.0, 5)
    v = np.repeat(levels, n // 5)
    dt = JRec.DT_MS
    k1, k2, k3 = JRec._gta_coeffs(JRec.MARKOV_B06, v)
    a, u = np.zeros(v.size), np.zeros(v.size)
    for k in range(1, v.size):
        for _ in range(10):
            h = dt / 10
            du = -k1[k] * a[k - 1] - k2[k] * u[k - 1] + k3[k]
            a[k - 1], u[k - 1] = a[k - 1] + h * u[k - 1], u[k - 1] + h * du
        a[k], u[k] = a[k - 1], u[k - 1]
    return v, a, u


def test_gta_coeffs_and_invert_gt_a_exact():
    v, a, u = _gta_trace()
    for x, y in zip(TRec._gta_coeffs(TReg.MARKOV_B06, v),
                    JRec._gta_coeffs(JRec.MARKOV_B06, v)):
        assert np.array_equal(x, y)
    got = TRec.invert_gt_a(a, u, n_outer=2)
    want = JRec.invert_gt_a(a, u, n_outer=2)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)


def test_boundaries_levels_and_segments_exact():
    rs = np.random.RandomState(1)
    v = np.repeat([-80.0, -120.0, -80.0, 40.0, -40.0], [300, 200, 250, 400,
                                                          350])
    i = 0.3 * (1 + 0.01 * rs.randn(v.size)).cumprod() * (v + 88.4)
    b_t = TRec.boundaries_from_trace(i)
    b_j = JRec.boundaries_from_trace(i)
    assert b_t.dtype == b_j.dtype and np.array_equal(b_t, b_j)
    assert b_t.size >= 4
    for b in b_t:
        assert TRec.level_from_ratio(i, b, -80.0, -88.4) == \
            JRec.level_from_ratio(i, b, -80.0, -88.4)
    sens = np.abs(rs.randn(v.size)) * 1e-6
    assert TRec.snap_segments(v, sens, b_t) == JRec.snap_segments(v, sens,
                                                                  b_t)
    seg_t = TRec.snap_segments(v, sens, b_t, sens_thresh=1.0)
    assert all(np.isnan(lvl) for _, _, lvl in seg_t)


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def test_fit_voltage_matches_jax(f64):
    """160 samples, two short stages, every sample but the first 20 free:
    the same RK4 rollout, loss and Adam/cosine steps in float64 (the
    gradients differ at round-off): the fitted voltages within 1e-7 mV."""
    v_true = np.repeat([-80.0, -20.0, 10.0, -60.0], 40)
    rs = np.random.RandomState(2)
    v0 = v_true + rs.randn(v_true.size)
    dt = JRec.DT_MS
    # targets: v_true's trajectory by a numpy rollout of the same
    # four-state RK4
    pm = [float(x) for x in JRec.MARKOV_B06]
    ph = [float(x) for x in J_HH]

    def rhs(y, v):
        a1 = pm[0] * np.exp(pm[1] * v)
        b1 = pm[2] * np.exp(-pm[3] * v)
        a2 = pm[8] * np.exp(pm[9] * v)
        b2 = pm[10] * np.exp(-pm[11] * v)
        return np.array([
            y[1], -(a1 * a2 + a1 * b2 + b1 * b2) * y[0]
            - (a1 + b1 + a2 + b2) * y[1] + a1 * a2,
            ph[0] * np.exp(ph[1] * v) * (1 - y[2])
            - ph[2] * np.exp(-ph[3] * v) * y[2],
            -ph[4] * np.exp(ph[5] * v) * y[3]
            + ph[6] * np.exp(-ph[7] * v) * (1 - y[3])])

    ys = [np.array([0.0, 0.0, 0.0, 1.0])]
    for k in range(v_true.size - 1):
        y, va, vb = ys[-1], v_true[k], v_true[k + 1]
        vm = 0.5 * (va + vb)
        k1 = rhs(y, va)
        k2 = rhs(y + 0.5 * dt * k1, vm)
        k3 = rhs(y + 0.5 * dt * k2, vm)
        k4 = rhs(y + dt * k3, vb)
        ys.append(y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4))
    ys = np.array(ys)
    a_ref = ys[:, 0]
    i_ref = float(J_TABLE1.g) * ys[:, 2] * ys[:, 3] * (v_true
                                                       - float(J_TABLE1.e))
    free = np.ones(v_true.size, bool)
    free[:20] = False
    stages = ((1e6, 1.0, 0.3, 6), (1e5, 100.0, 1.0, 4))
    got = TRec.fit_voltage(v0, a_ref, i_ref, TReg.HH_D0_FIT, TReg.TABLE1,
                           free=free, stages=stages, verbose=False,
                           device="cpu")
    want = JRec.fit_voltage(v0, a_ref, i_ref, J_HH, J_TABLE1, free=free,
                            stages=stages, verbose=False)
    assert got.dtype == np.float64 and got.shape == v0.shape
    assert np.array_equal(got[:20], v0[:20])
    assert not np.array_equal(got[20:], v0[20:])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_cosine_schedule_is_optax():
    import optax

    for lr, iters in ((0.3, 400), (1.0, 7)):
        sched = optax.cosine_decay_schedule(lr, iters, alpha=0.01)
        for k in (0, 1, iters // 2, iters - 1, iters, iters + 3):
            assert TRec._cosine_lr(lr, iters, k) == pytest.approx(
                float(sched(k)), rel=1e-12)


def test_save_asset_into_tmp(monkeypatch, tmp_path):
    """Both packages write the same npz (v float32, dt float64), read back
    by the port's load_voltage; ionflux/assets/ is never touched."""
    monkeypatch.setattr(TRec, "ASSET_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(JRec, "ASSET_DIR", str(tmp_path / "jax"))
    v = np.random.RandomState(3).uniform(-120.0, 60.0, 999)
    p_t = TRec.save_asset("standin", v, dt=0.5)
    p_j = JRec.save_asset("standin", v, dt=0.5)
    assert p_t == str(tmp_path / "port" / "standin.npz")
    with np.load(p_t) as zt, np.load(p_j) as zj:
        assert sorted(zt.files) == sorted(zj.files) == ["dt", "v"]
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype
            assert np.array_equal(zt[k], zj[k])
    v_back, dt = TRec.load_voltage("standin")
    assert dt == 0.5 and np.array_equal(v_back, v.astype(np.float32))
