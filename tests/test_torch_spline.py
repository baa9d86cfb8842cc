"""ionflux_torch.ops.spline (the Thomas solve, the interpolating cubic
spline), the tensor forms of ionflux_torch.ops.smoothing and the on-device
derivative surface (ionflux_torch.surface.estimate_gate_surface_ondevice)
against their ionflux counterparts, and the surface against the port's
scipy path at tests/test_spline.py's bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from ionflux import protocols as JP
from ionflux.ops import smoothing as JSm
from ionflux.ops import spline as JS
from ionflux.surface import (
    SurfaceConfig as JSurfaceConfig,
    estimate_gate_surface_ondevice as j_ondevice,
    spline_didt_segment_jax as j_segment,
)
from ionflux_torch import protocols as TP
from ionflux_torch.eval import simulate_family
from ionflux_torch.models.registry import HH_B06, SYNTHETIC
from ionflux_torch.ops import smoothing as TSm
from ionflux_torch.ops import spline as TS
from ionflux_torch.surface import (
    SurfaceConfig,
    estimate_gate_surface,
    estimate_gate_surface_ondevice,
    spline_didt_segment_jax,
)

# float32 in both; the Thomas recurrences in the same order, XLA may fuse
# a multiply-add where PyTorch rounds twice: relative 1e-6 of the scale
REL = 1e-6


def _f32(x):
    return np.asarray(x, np.float32)


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    return (_f32(rng.uniform(0.5, 1.0, n)), _f32(rng.uniform(3.0, 4.0, n)),
            _f32(rng.uniform(0.5, 1.0, n)), _f32(rng.normal(size=n)))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("k", [None, 3])
def test_tridiag_solve_matches_jax(k):
    dl, d, du, b = _system(40)
    if k is not None:
        b = _f32(np.random.default_rng(1).normal(size=(40, k)))
    got = TS.tridiag_solve(*(torch.from_numpy(x) for x in (dl, d, du, b)))
    want = JS.tridiag_solve(*(jnp.asarray(x) for x in (dl, d, du, b)))
    _close(got, want)


def test_batched_thomas_equals_one_system_at_a_time():
    """Systems of 1, 2, 7 and 40 rows packed into one batch (K1's layout):
    each equal bit for bit to its own solve."""
    systems = [_system(n, seed=n) for n in (7, 1, 40, 2)]
    packed = [torch.from_numpy(np.concatenate([s[i] for s in systems]))
              for i in range(4)]
    x = TS.tridiag_solve_batched(*packed, [s[0].size for s in systems])
    at = 0
    for s in systems:
        one = TS.tridiag_solve(*(torch.from_numpy(v) for v in s))
        assert torch.equal(x[at:at + s[0].size], one)
        at += s[0].size


@pytest.mark.parametrize("bc", ["not-a-knot", "natural"])
def test_cubic_spline_m_and_derivative_match_jax(bc):
    h = 0.25
    t = np.arange(80) * h
    y = _f32(np.sin(0.7 * t) + 0.3 * np.cos(2.1 * t))
    m_t = TS.cubic_spline_m(torch.from_numpy(y), h, bc=bc)
    m_j = JS.cubic_spline_m(jnp.asarray(y), h, bc=bc)
    _close(m_t, m_j, rel=1e-5)      # 6 / h^2 second differences of f32 y
    d_t = TS.spline_derivative(torch.from_numpy(y), h, bc=bc)
    _close(d_t, JS.spline_derivative(jnp.asarray(y), h, bc=bc))
    if bc == "not-a-knot":
        np.testing.assert_allclose(d_t.numpy(), CubicSpline(
            t, y.astype(np.float64), bc_type="not-a-knot")(t, 1), atol=1e-5)


def test_spline_derivative_segments_one_launch_per_batch():
    """Four segments (one too short for the tridiagonal part) in one
    Thomas call, each equal to its own spline_derivative."""
    ys = [torch.from_numpy(_f32(np.sin(np.arange(n) * 0.1)))
          for n in (5, 6, 50, 4)]
    for y, d in zip(ys, TS.spline_derivative_segments(ys, 0.1)):
        assert torch.equal(d, TS.spline_derivative(y, 0.1))


@pytest.mark.parametrize("window", [11, 61])
def test_smoothing_matches_jax(window):
    x = _f32(np.random.default_rng(0).normal(size=500))
    _close(TSm.smooth_same(torch.from_numpy(x), window),
           JSm.smooth_same(jnp.asarray(x), window))
    for deriv in (0, 1):
        _close(TSm.savitzky_golay(torch.from_numpy(x), 11, 3, deriv),
               JSm.savitzky_golay(jnp.asarray(x), 11, 3, deriv))
    _close(TSm.smooth_same(torch.from_numpy(x), window),
           TSm.smooth_same_np(x, window))


@pytest.fixture(scope="module")
def surface_inputs():
    """A 10,001-sample deactivation protocol at 1 ms and the HH_B06
    current on it plus noise (RandomState(0), 0.01)."""
    proto = TP.deactivation_protocol(-40.0, 1.0, device="cpu")
    ts = proto.times()
    cur = simulate_family("hh", HH_B06, [proto], ts,
                          SYNTHETIC)[0].double().numpy()
    cur = cur + 0.01 * np.random.RandomState(0).randn(cur.size)
    v = proto.v.numpy()
    steps = np.flatnonzero(v[1:] != v[:-1]) + 1
    mask = TP.derivative_mask(v.size, steps.tolist())
    return proto, ts, cur, mask


def test_segment_function_matches_jax(surface_inputs):
    _, _, cur, _ = surface_inputs
    seg = _f32(cur[:2000])
    sm_t, d_t = spline_didt_segment_jax(torch.from_numpy(seg), 1.0)
    sm_j, d_j = j_segment(jnp.asarray(seg), 1.0)
    _close(sm_t, sm_j)
    # the convolutions sum in other orders (smoothed currents within ~5e-7);
    # the derivative of such a rounding difference d is up to ~2 d / h, on
    # a derivative whose scale is ~0.02: 5e-5 of the scale
    _close(d_t, d_j, rel=5e-5)


def test_ondevice_surface_matches_jax_and_scipy_path(surface_inputs):
    proto, ts, cur, mask = surface_inputs
    assert ts.shape[0] == 10001
    got = estimate_gate_surface_ondevice(proto, ts, torch.from_numpy(
        _f32(cur)), HH_B06, SYNTHETIC, mask)
    pj = JP.deactivation_protocol(-40.0, dt_ms=1.0)
    from ionflux.models.registry import HH_B06 as J_HH_B06
    from ionflux.models.registry import SYNTHETIC as J_SYNTHETIC
    want = j_ondevice(pj, jnp.asarray(ts.numpy()), jnp.asarray(_f32(cur)),
                      J_HH_B06, J_SYNTHETIC, mask, JSurfaceConfig())
    assert [len(x) for x in got] == [len(x) for x in want]
    assert np.array_equal(got[0], np.asarray(want[0]))
    # a and dadt: two f32 on-device estimators whose r-gate solves (two
    # adaptive f32 solves) and convolution sums part at round-off; held to
    # the bounds tests/test_spline.py holds JAX's one to against the scipy
    # path (measured: 5.3e-7 and 1.3e-7 RMS)
    for g, w, bound in zip(got[1:], want[1:], (1e-6, 5e-6)):
        assert np.sqrt(np.mean((g - np.asarray(w)) ** 2)) < bound
    # the port's scipy (FITPACK, f64) path, at tests/test_spline.py's bounds
    v1, a1, d1 = estimate_gate_surface(proto, ts, cur, HH_B06, SYNTHETIC,
                                       mask, SurfaceConfig())
    assert len(v1) == len(got[0])
    assert np.sqrt(np.mean((a1 - got[1]) ** 2)) < 1e-6
    assert np.sqrt(np.mean((d1 - got[2]) ** 2)) < 5e-6
    with pytest.raises(ValueError, match="s=0"):
        estimate_gate_surface_ondevice(proto, ts, torch.from_numpy(
            _f32(cur)), HH_B06, SYNTHETIC, mask, SurfaceConfig(spline_s=1.0))


def test_scipy_path_s0_equals_fitpack(surface_inputs):
    """The port's scipy path builds the s = 0 spline with
    make_interp_spline (scipy 1.18 refuses UnivariateSpline's
    set_smoothing_factor(0)); where FITPACK still takes it, the two are
    equal to machine precision (1e-9 of each array's scale)."""
    from scipy.interpolate import UnivariateSpline

    from ionflux_torch.surface import spline_didt

    proto, ts, cur, _ = surface_inputs
    t = ts.double().numpy()
    edges = TP.segment_edges(t, proto.v.double().numpy())
    cfg = SurfaceConfig()
    got = spline_didt(t, cur, edges, cfg)
    want = [np.zeros_like(t), np.zeros_like(t)]
    t_i = 0.0
    for t_f in edges:
        idx = np.where((t >= t_i) & (t < t_f))[0]
        t_i = t_f
        if len(idx) <= cfg.smooth_window:
            continue
        fit = TSm.smooth_same_np(cur[idx], cfg.smooth_window)
        try:
            spl = UnivariateSpline(t[idx], fit, k=3)
            spl.set_smoothing_factor(0.0)
            want[0][idx], want[1][idx] = spl(t[idx]), spl.derivative()(
                t[idx])
        except ValueError:
            pytest.skip("this scipy's FITPACK refuses the s = 0 refit")
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max()
