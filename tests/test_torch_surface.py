"""The leaves the surface-training path stands on (masks, ``load_csv``, the
HH steady state, ``mlp_init``, the registry's d-study sets, checkpoints),
the synthetic data and the derivative surface of ionflux_torch against
ionflux, on the same inputs.

Tolerances: the numpy leaves (masks, smoothing, the noise stream) are equal
exactly; elementwise torch-vs-JAX f32 arithmetic agrees to rtol 1e-6; the
ground-truth currents, solved adaptively by each package (their f32 step
sequences part at round-off), agree to 1e-5 of their range off the voltage
step edges and to 5e-5 at them; the surface's
(v, a, dadt) to 1e-3 of each array's range (the spline amplifies the
currents' round-off where a segment's current is small)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import data as JD
from ionflux import protocols as JP
from ionflux import surface as JS
from ionflux.models import hh as JH
from ionflux.models import nn as JN
from ionflux.models import registry as JR
from ionflux.ops import smoothing as JSm
from ionflux.utils import ckpt as JC
from ionflux_torch import data as TD
from ionflux_torch import protocols as TP
from ionflux_torch import surface as TS
from ionflux_torch.models import hh as TH
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.ops import smoothing as TSm
from ionflux_torch.utils import ckpt as TC

from _torch_helpers import assert_close, jax_net, np_, np_net, torch_net

F32 = 1e-6           # elementwise f32 arithmetic, relative


def _v_trace(seed=0, n=3000):
    """A step voltage trace with a few repeated levels."""
    rs = np.random.RandomState(seed)
    levels = rs.choice([-80.0, -40.0, 0.0, 20.0, 40.0], size=12)
    return np.repeat(levels, n // 12)


@pytest.mark.parametrize("fn", ["change_points", "capacitance_mask",
                                "training_mask", "segment_edges",
                                "derivative_mask", "s_study_masks"])
def test_mask_leaves_equal(fn):
    v = _v_trace()
    t = np.arange(len(v)) * 0.1
    if fn == "segment_edges":
        got, want = TP.segment_edges(t, v), JP.segment_edges(t, v)
    elif fn == "derivative_mask":
        got = TP.derivative_mask(len(v), [250, 1000, 2990], lo=3, hi=40)
        want = JP.derivative_mask(len(v), [250, 1000, 2990], lo=3, hi=40)
    elif fn == "s_study_masks":
        got, want = np.stack(TP.s_study_masks()[0]), np.stack(
            JP.s_study_masks()[0])
        np.testing.assert_array_equal(TP.s_study_masks()[1],
                                      JP.s_study_masks()[1])
    else:
        extra = np.zeros(len(v), bool)
        extra[1234] = True
        kw = {} if fn == "change_points" else {"extra_changes": extra}
        got, want = getattr(TP, fn)(v, **kw), getattr(JP, fn)(v, **kw)
    np.testing.assert_array_equal(got, want)


def test_load_csv_equal(tmp_path):
    v = _v_trace(1, 600)
    path = tmp_path / "proto.csv"
    np.savetxt(path, np.stack([np.arange(len(v)) * 1e-4, v], axis=1),
               delimiter=",", header="time,voltage", comments="")
    got, want = TP.load_csv(str(path), device="cpu"), JP.load_csv(str(path))
    assert_close(got.v, want.v, atol=0.0)
    assert_close(got.dt, want.dt, atol=0.0, rtol=F32)
    assert float(got.t0) == float(want.t0)


def test_hh_steady_state_and_time_constants():
    v = np.linspace(-120.0, 60.0, 37).astype(np.float32)
    for fn in ("hh_steady_state", "hh_time_constants"):
        got = getattr(TH, fn)(TR.HH_B06, torch.from_numpy(v))
        want = getattr(JH, fn)(JR.HH_B06, jnp.asarray(v, jnp.float32))
        assert_close(got, want, atol=0.0, rtol=F32)


def test_registry_d_study_sets_equal():
    assert tuple(TR.HH_D0_INIT) == tuple(JR.HH_D0_INIT)
    assert tuple(TR.HH_D_PRETRAIN) == tuple(JR.HH_D_PRETRAIN)


def test_mlp_init_layout():
    """Same shapes, dtype and zero biases as the reference; the weights'
    streams differ (torch.Generator vs jax.random), their spread does not;
    MLP.init draws the same numbers as mlp_init."""
    import jax

    sizes = TN.mlp_sizes(5, 200)
    got = TN.mlp_init(torch.Generator().manual_seed(3), sizes, 0.1,
                      device="cpu")
    want = JN.mlp_init(jax.random.PRNGKey(3), sizes, 0.1)
    assert [tuple(w.shape) for w, _ in got] == [w.shape for w, _ in want]
    assert all(w.dtype == torch.float32 and not b.any() for w, b in got)
    w_all = torch.cat([w.reshape(-1) for w, _ in got])
    assert abs(float(w_all.std()) - 0.1) < 2e-3
    mlp = TN.MLP.init(sizes, torch.Generator().manual_seed(3), 0.1, "cpu")
    assert all(torch.equal(a, w) for (a, _), (w, _) in zip(mlp.layers, got))


def _nnd_pair(seed=0):
    net = np_net(seed, n_layers=1, n_nodes=16)
    return (JN.NNdParams(jax_net(net), JR.HH_D2_BASE),
            TN.NNdParams(TN.MLP(torch_net(net)), TR.HH_D2_BASE), net)


def test_model_npz_loads_in_both_packages(tmp_path):
    """model.npz written by one package loads in the other, leaf for leaf."""
    jp, tp, net = _nnd_pair()
    JC.save_pytree(str(tmp_path / "jax.npz"), jp)
    TC.save_pytree(str(tmp_path / "torch.npz"), tp)
    from_jax = TC.load_pytree(str(tmp_path / "jax.npz"), "nnd", "cpu")
    from_torch = JC.load_pytree(str(tmp_path / "torch.npz"), jp)
    for (w, b), (wj, bj), (wn, bn) in zip(from_jax.net.layers,
                                          from_torch.net, net):
        for x in (w, wj):
            np.testing.assert_array_equal(np_(x), wn)
        for x in (b, bj):
            np.testing.assert_array_equal(np_(x), bn)
    assert tuple(from_jax.hh) == tuple(JR.HH_D2_BASE)
    assert [float(x) for x in from_torch.hh] == [float(x)
                                                 for x in JR.HH_D2_BASE]


def test_checkpoints_load_in_both_packages(tmp_path):
    """save_checkpoint / load_checkpoint both ways (params, epoch, loss, the
    best copy), and the optimiser leaves round-trip in the port."""
    from ionflux_torch.fit.train import init_opt_state

    jp, tp, net = _nnd_pair(1)
    opt = init_opt_state(tp.net)
    opt = opt._replace(count=7, mu=[(w + 1.0, b - 1.0) for w, b in opt.mu])
    JC.save_checkpoint(str(tmp_path / "j"), jp, [np.zeros(3)], 5, [0.5, 0.25],
                       suffix="-2", is_best=True)
    TC.save_checkpoint(str(tmp_path / "t"), tp, opt, 5, [0.5, 0.25],
                       suffix="-2", is_best=True)
    p1, _, e1, l1 = TC.load_checkpoint(str(tmp_path / "j"), "nnd", suffix="-2",
                                       best=True, device="cpu")
    p2, _, e2, l2 = JC.load_checkpoint(str(tmp_path / "t"), jp, suffix="-2")
    p3, o3, _, _ = TC.load_checkpoint(str(tmp_path / "t"), tp, opt,
                                      suffix="-2", device="cpu")
    assert (e1, l1) == (e2, l2) == (5, [0.5, 0.25])
    for (w1, _), (w2, _), (w3, _), (wn, _) in zip(p1.net.layers, p2.net,
                                                  p3.net.layers, net):
        for w in (w1, w2, w3):
            np.testing.assert_array_equal(np_(w), wn)
    assert o3.count == 7
    assert all(torch.equal(a, b) for pa, pb in zip(o3.mu, opt.mu)
               for a, b in zip(pa, pb))


def test_model_bundle_spec_json_equal(tmp_path):
    """save_model_bundle writes the same spec.json for the same study."""
    from ionflux import studies as JSt
    from ionflux_torch import studies as TSt

    jp, tp, _ = _nnd_pair()
    JC.save_model_bundle(str(tmp_path / "j.npz"), jp, JSt.D2)
    TC.save_model_bundle(str(tmp_path / "t.npz"), tp, TSt.D2)
    with open(tmp_path / "j.spec.json") as fj, open(tmp_path /
                                                    "t.spec.json") as ft:
        got, want = json.load(ft), json.load(fj)
    got.pop("params_file"), want.pop("params_file")
    assert got == want


@pytest.mark.parametrize("fn", ["smooth_same_np", "savitzky_golay_np"])
def test_smoothing_equal(fn):
    x = np.sin(np.linspace(0, 20, 701)) + 0.1 * np.random.RandomState(
        0).randn(701)
    if fn == "smooth_same_np":
        got, want = TSm.smooth_same_np(x, 61), JSm.smooth_same_np(x, 61)
    else:
        got = TSm.savitzky_golay_np(x, 31, 3, deriv=1, rate=10.0)
        want = JSm.savitzky_golay_np(x, 31, 3, deriv=1, rate=10.0)
    np.testing.assert_array_equal(got, want)


def test_synth_study_currents_match():
    """Markov ground truth on the 7 + 9 step protocols, on every 100th
    sample of the study grids: the noise stream identical, the currents
    within 1e-5 of their range at 50 ms and more from a voltage step edge,
    within 5e-5 on every sample (at an edge the two packages' adaptive
    steps straddle it differently: ROADMAP's measured properties)."""
    from ionflux_torch import studies as TSt

    t1, t2 = TSt.T1[::100].astype(np.float32), TSt.T2[::100].astype(
        np.float32)
    n_got = TD.noise_sequence([t1.shape] * 7 + [t2.shape] * 9)
    n_want = JD.noise_sequence([t1.shape] * 7 + [t2.shape] * 9)
    for a, b in zip(n_got, n_want):
        np.testing.assert_array_equal(a, b)
    act, deact = TD.synth_study_currents(TR.MARKOV_B06, torch.from_numpy(t1),
                                         torch.from_numpy(t2))
    ja, jd = JD.synth_study_currents(JR.MARKOV_B06,
                                     jnp.asarray(t1, jnp.float32),
                                     jnp.asarray(t2, jnp.float32))
    assert act.shape == (7, t1.size) and deact.shape == (9, t2.size)
    for got, want, t, edges in ((act, ja, t1, (1000, 6000, 7000, 7500)),
                                (deact, jd, t2, (1000, 3000, 9000, 9500))):
        rng = float(np.ptp(want))
        assert_close(got, want, atol=5e-5 * rng)
        far = np.abs(t[:, None] - np.array(edges)[None]).min(axis=1) >= 50.0
        assert_close(got[:, far], want[:, far], atol=1e-5 * rng)


def test_estimate_gate_surface_matches():
    """The whole per-protocol pipeline (r-gate solve, smoothing, spline
    derivative, inversion, mask, subsample) with d2's settings on one
    activation protocol at 1 ms knots and a noisy Markov current given to
    both: (v, a, dadt) within 1e-3 of each array's range."""
    cfg_t = TS.SurfaceConfig(sparse=21, smooth_window=151, spline_s=1.0)
    cfg_j = JS.SurfaceConfig(sparse=21, smooth_window=151, spline_s=1.0)
    t = np.linspace(0.0, 8000.0, 8001).astype(np.float32)
    pt = TP.activation_protocol(20.0, 1.0, device="cpu")
    pj = JP.activation_protocol(20.0, dt_ms=1.0)
    cur = TD.simulate_current(TR.MARKOV_B06, pt, torch.from_numpy(t))
    cur = np_(cur).astype(np.float64) + np.random.RandomState(0).normal(
        0.0, 0.1, t.shape)
    mask = JP.derivative_mask(8001, [1000, 6000, 7000, 7500])
    got = TS.estimate_gate_surface(pt, torch.from_numpy(t), cur,
                                   TR.HH_D0_INIT, TR.SYNTHETIC, mask, cfg_t)
    want = JS.estimate_gate_surface(pj, jnp.asarray(t, jnp.float32), cur,
                                    JR.HH_D0_INIT, JR.SYNTHETIC, mask, cfg_j)
    assert got[0].size > 300
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-3 * float(np.ptp(w)))
