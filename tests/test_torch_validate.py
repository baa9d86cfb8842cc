"""Checkpoint validation on recorded protocols: the chained popsweep
(ops/fused_solve.py::fused_nnf_popsweep_chained), eval.simulate_population_real
and eval.population_rollout_maes against ionflux (Pallas in interpret mode)
on tiny stand-in recordings, as tests/test_pallas.py runs them.

Both packages run the same trip algorithm in f32 and chain the same segments:
the executed trips (n_valid) of every segment are equal and the accepted
steps agree to 5%; the gates agree to 1e-4 at 50 ms and more from a voltage
step edge and to ~1e-2 at the edges (``_torch_helpers.ts_between_edges``).
Currents are g a r (V - E) with |V - E| <= 126 mV here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import eval as JE
from ionflux import protocols as JP
from ionflux.models import nn as JN
from ionflux.models import registry as JR
from ionflux.ops import pallas_solve as JK
from ionflux_torch import eval as TE
from ionflux_torch import protocols as TP
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.ops import fused_solve as TK

from _torch_helpers import (assert_close, jax_net, np_, np_net, torch_net,
                            ts_between_edges)

GATE_TOL = 1e-4       # between edges (test_torch_popsweep.py)
CHAIN_TOL = 1e-3      # chained vs one launch (tests/test_pallas.py:466)
EDGE_FREE_MS = 50.0   # samples this far from a step edge
NAMES = ["a", "b"]


def _standins():
    """test_pallas.py's stand-ins: a 6,001- and a 3,501-sample recording at
    1 ms (activation steps to +20 and -30 mV)."""
    pa = JP.activation_protocol(20.0, dt_ms=1.0)
    pb = JP.activation_protocol(-30.0, dt_ms=1.0)
    return {"a": (np.asarray(pa.v)[:6001], 1.0),
            "b": (np.asarray(pb.v)[:3501], 1.0)}


KW = dict(trips=1024, seg_samples=2048, chunk=512)


def _pops(net):
    return (JN.NNfParams(jax_net(net), JR.HH_B06),
            TN.NNfParams(TN.MLP(torch_net(net)), TR.HH_B06))


def _edge_free(v: np.ndarray, dt: float) -> np.ndarray:
    """Samples at least EDGE_FREE_MS from every voltage step of v."""
    edges = np.flatnonzero(np.diff(v) != 0) + 1
    t = np.arange(len(v)) * dt
    if not len(edges):
        return np.ones(len(v), bool)
    d = np.abs(t[:, None] - edges[None, :] * dt).min(axis=1)
    return d >= EDGE_FREE_MS


def test_popsweep_chained_matches_reference_and_single_launch():
    """test_pallas.py::test_popsweep_chained_matches_single_launch's shapes:
    2 members of 1 x 16, two activation protocols at 1 ms cut into two
    4,000 ms segments (the cut falls mid-sweep).  The chain against the
    reference's chain (gates and final state) and against one launch over
    the whole span.  (The second segment ends a few trips past a 256-trip
    block in the reference and just inside it here, so the executed trips
    differ by a block: ROADMAP's measured properties.)"""
    net = np_net(1, members=2)
    vs = np.stack([np.asarray(JP.activation_protocol(v, dt_ms=1.0).v)
                   for v in (-40.0, 20.0)])
    seg = 4000
    pad = np.concatenate([vs, vs[:, -1:]], axis=1)
    seg_v = np.stack([pad[:, b * seg:b * seg + seg + 1] for b in range(2)])
    tsj, tst = ts_between_edges(4000.0)          # local, 50 ms off edges
    kw = dict(proto_dt=1.0, t_end=4000.0, trips=2048)
    seen = {"jax": [], "torch": []}

    def keep(pkg, ts):
        return lambda b, r: seen[pkg].append(r.evaluate(ts))

    _, fin_j = JK.fused_nnf_popsweep_chained(
        jax_net(net), JR.HH_B06, jnp.asarray(seg_v), interpret=True,
        consume=keep("jax", tsj), **kw)
    ys_t, fin_t = TK.fused_nnf_popsweep_chained(
        torch_net(net), TR.HH_B06, torch.from_numpy(seg_v), ts=tst, **kw)
    _, fin_c = TK.fused_nnf_popsweep_chained(
        torch_net(net), TR.HH_B06, torch.from_numpy(seg_v),
        consume=keep("torch", tst), **kw)
    assert tuple(ys_t.shape) == (2, 2, 2, tst.shape[0], 2)
    assert bool(torch.isfinite(ys_t).all()) and tuple(fin_t.shape) == (2, 2,
                                                                       2)
    assert torch.equal(fin_c, fin_t)
    assert_close(fin_t, fin_j, atol=GATE_TOL)
    for b, (ys_j, ys_c) in enumerate(zip(seen["jax"], seen["torch"])):
        assert torch.equal(ys_c, ys_t[b])
        assert_close(ys_t[b], ys_j, atol=GATE_TOL)
    for b, t0 in enumerate((0.0, 4000.0)):
        one = TK.fused_nnf_popsweep_solve_ft(
            torch_net(net), TR.HH_B06, torch.from_numpy(vs), t0 + tst,
            proto_dt=1.0, trips=2048)
        assert float((ys_t[b] - one).abs().max()) < CHAIN_TOL


def test_popsweep_chained_needs_times_or_consume():
    net = torch_net(np_net(1, members=2))
    seg_v = torch.zeros(2, 2, 101)
    with pytest.raises(ValueError, match="consume"):
        TK.fused_nnf_popsweep_chained(net, TR.HH_B06, seg_v, proto_dt=1.0)


def test_segment_recordings_match_reference():
    """The host-side segmentation is the reference's, array for array."""
    volts = _standins()
    for seg, chunk in ((2048, 512), (1000, 300), (7000, 4096)):
        got = TE._segment_recordings(NAMES, seg_samples=seg, chunk=chunk,
                                     voltages=volts)
        want = JE._segment_recordings(NAMES, seg_samples=seg, chunk=chunk,
                                      voltages=volts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_simulate_population_real_matches_reference():
    """Two members on the stand-ins (segments of 2,048 samples, chunks of
    512, 1,024 trips): each protocol sliced back to its own length, the
    currents against the reference's at every sample 50 ms or more from a
    step edge (1e-4 on the gates x 126 mV), and everywhere to 1e-2 x 126
    mV; each member also against the plain adaptive solve (the reference
    test's 2% of the range)."""
    jpop, tpop = _pops(np_net(1, members=2))
    volts = _standins()
    cur_t = TE.simulate_population_real("nnf", tpop, NAMES, TR.SYNTHETIC,
                                        voltages=volts, **KW)
    cur_j = JE.simulate_population_real("nnf", jpop, NAMES, JR.SYNTHETIC,
                                        voltages=volts, interpret=True, **KW)
    for n, ln in (("a", 6001), ("b", 3501)):
        assert cur_t[n].shape == (2, ln) and cur_t[n].dtype == np.float32
        assert np.isfinite(cur_t[n]).all()
        far = _edge_free(volts[n][0], 1.0)
        assert_close(cur_t[n][:, far], cur_j[n][:, far],
                     atol=126 * GATE_TOL)
        assert_close(cur_t[n], cur_j[n], atol=126 * 1e-2)
        proto = TP.Protocol(torch.tensor(0.0), torch.tensor(1.0),
                            torch.from_numpy(volts[n][0].astype(
                                np.float32)))
        ts = torch.arange(ln, dtype=torch.float32)
        member = TN.NNfParams(tpop.net.member(0), TR.HH_B06)
        i_ref = np_(TE.simulate("nnf", member, proto, ts, TR.SYNTHETIC,
                                rtol=1e-5, atol=1e-7))
        err = float(np.abs(cur_t[n][0] - i_ref).max())
        assert err < 2e-2 * (i_ref.max() - i_ref.min()), (n, err)


def test_simulate_population_real_segments_match_reference():
    """The chain the stand-ins run, segment by segment: equal n_valid and
    n_acc within 5% in every segment of both packages."""
    net = np_net(1, members=2)
    _, _, seg, _, _, seg_v, _ = TE._segment_recordings(
        NAMES, seg_samples=KW["seg_samples"], chunk=KW["chunk"],
        voltages=_standins())
    stats = {"jax": [], "torch": []}
    kw = dict(proto_dt=1.0, t_end=float(seg), trips=KW["trips"])
    JK.fused_nnf_popsweep_chained(
        jax_net(net), JR.HH_B06, jnp.asarray(seg_v), interpret=True,
        consume=lambda b, r: stats["jax"].append(
            (int(r.n_valid), int(r.n_acc))), **kw)
    TK.fused_nnf_popsweep_chained(
        torch_net(net), TR.HH_B06, torch.from_numpy(seg_v),
        consume=lambda b, r: stats["torch"].append(
            (int(r.n_valid), int(r.n_acc))), **kw)
    assert len(stats["torch"]) == len(stats["jax"]) == 3
    for (nv_j, na_j), (nv_t, na_t) in zip(stats["jax"], stats["torch"]):
        assert nv_t == nv_j and na_t > 0
        assert abs(na_t - na_j) <= 0.05 * na_j


def test_population_rollout_maes_matches_host_reduction_and_reference():
    """test_pallas.py::test_population_rollout_maes_matches_host_reduction:
    the device-side reduction equals the host reduction over
    simulate_population_real's currents (rtol 2e-4, atol 1e-6, the
    reference test's bound) with a span on "b" and unequal lengths, and the
    reference's MAEs to 1e-3 relative."""
    jpop, tpop = _pops(np_net(1, members=2))
    volts = _standins()
    cur = TE.simulate_population_real("nnf", tpop, NAMES, TR.SYNTHETIC,
                                      voltages=volts, **KW)
    rng = np.random.default_rng(0)
    truth = {n: cur[n][0] + 0.01 * rng.standard_normal(cur[n].shape[1])
             for n in NAMES}
    spans = {"b": (500, 3000)}
    want = np.stack([
        np.stack([np.mean(np.abs(cur["a"][m] - truth["a"])),
                  np.mean(np.abs(cur["b"][m, 500:3000]
                                 - truth["b"][500:3000]))])
        for m in range(2)])
    got = TE.population_rollout_maes("nnf", tpop, NAMES, TR.SYNTHETIC, truth,
                                     spans=spans, voltages=volts, **KW)
    assert got.shape == (2, 2) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    ref = JE.population_rollout_maes("nnf", jpop, NAMES, JR.SYNTHETIC, truth,
                                     spans=spans, voltages=volts,
                                     interpret=True, **KW)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=0)


def test_dead_lane_scores_inf_over_its_whole_trace():
    """A member whose weights are scaled by 1e6 dies in the first segment:
    its currents are inf over every protocol's whole trace, its MAEs inf;
    the other member is untouched (equal to its own population of one)."""
    net = np_net(1, members=2)
    net = [(w * np.array([1.0, 1e6], np.float32)[:, None, None], b)
           for w, b in net]
    _, tpop = _pops(net)
    volts = _standins()
    cur = TE.simulate_population_real("nnf", tpop, NAMES, TR.SYNTHETIC,
                                      voltages=volts, **KW)
    for n in NAMES:
        assert np.isinf(cur[n][1]).all() and np.isfinite(cur[n][0]).all()
    truth = {n: cur[n][0] for n in NAMES}
    maes = TE.population_rollout_maes("nnf", tpop, NAMES, TR.SYNTHETIC,
                                      truth, voltages=volts, **KW)
    assert np.isinf(maes[1]).all() and (maes[0] == 0.0).all()


def test_mixed_sample_rates_are_refused():
    volts = _standins()
    volts["b"] = (volts["b"][0], 0.5)
    _, tpop = _pops(np_net(1, members=2))
    for fn in (TE.simulate_population_real, TE.population_rollout_maes):
        args = ({n: np.zeros(6001) for n in NAMES},) if (
            fn is TE.population_rollout_maes) else ()
        with pytest.raises(ValueError, match="mixed sample rates"):
            fn("nnf", tpop, NAMES, TR.SYNTHETIC, *args, voltages=volts, **KW)


def test_rollout_maes_refuse_short_truth():
    _, tpop = _pops(np_net(1, members=2))
    truth = {"a": np.zeros(6001), "b": np.zeros(3000)}
    with pytest.raises(ValueError, match="truth"):
        TE.population_rollout_maes("nnf", tpop, NAMES, TR.SYNTHETIC, truth,
                                   voltages=_standins(), **KW)


def test_report_mae_prints_the_reference_line(capsys):
    pred, truth = np.array([1.0, 2.0, 3.0]), np.array([1.5, 2.0, 2.0])
    got = TE.report_mae("pr3", torch.tensor(pred), torch.tensor(truth))
    want = JE.report_mae("pr3", jnp.asarray(pred), jnp.asarray(truth))
    assert got == pytest.approx(want) == pytest.approx(0.5)
    out = capsys.readouterr().out.splitlines()
    assert out == ["pr3 | Total Loss 0.500000"] * 2
