"""The studies module (ionflux_torch/studies.py) against ionflux/studies.py:
the specs, run_study_validated's checkpoint selection, and
table_rollout_maes_pop's bookkeeping (padding, the Pr4 span, the rescore
of non-finite rows) on stand-in recordings.

Both run_study_validated runs take the same cached surface, the same initial
nets (init_params patched in both packages) and one scripted metric:
scripted offsets plus each package's validation loss of the checkpoint, so
the two score sequences agree to 1e-3 relative (the Adam traces' tolerance,
test_torch_train.py) and select the same (seed, iteration).  The rollout
MAEs of the batched path agree to 2e-3 relative: the plain trip solve
against the Pallas kernel in interpret mode, the MAEs dominated by the
targets' 0.1 noise."""

import functools
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ionflux.eval as JE
from ionflux import protorec as JRec
from ionflux import studies as JSt
from ionflux.fit import train as JT
from ionflux.models import nn as JN
from ionflux.models import registry as JR
from ionflux.utils import ckpt as JC
from ionflux_torch import protorec as TRec
from ionflux_torch import studies as TSt
from ionflux_torch.fit import train as TT
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR

from _torch_helpers import assert_close, jax_net, np_, np_net, torch_net

SCORE_RTOL = 1e-3
MAE_RTOL = 2e-3


def _fields(spec):
    return {k: (tuple(float(x) for x in v) if isinstance(v, tuple) else
                v.__dict__ if hasattr(v, "__dataclass_fields__") else v)
            for k, v in spec.__dict__.items()}


@pytest.mark.parametrize("name", ["S1", "S2", "D1", "D2", "D2_PARITY"])
def test_specs_equal(name):
    assert _fields(getattr(TSt, name)) == _fields(getattr(JSt, name))
    assert sorted(TSt.STUDIES) == sorted(JSt.STUDIES)
    np.testing.assert_array_equal(TSt.T1, JSt.T1)
    np.testing.assert_array_equal(TSt.T2, JSt.T2)


def _write_surface(outdir, n=400, seed=0):
    """A small cached surface.npz (v mV, a, dadt) with a few points outside
    0 < a < 1 that the runner must drop."""
    rs = np.random.RandomState(seed)
    v = rs.uniform(-120.0, 40.0, n)
    a = rs.uniform(-0.1, 1.1, n)
    p = JR.HH_D_PRETRAIN
    dadt = (float(p.p1) * np.exp(float(p.p2) * v) * (1 - a)
            - float(p.p3) * np.exp(-float(p.p4) * v) * a)
    os.makedirs(outdir, exist_ok=True)
    np.savez(os.path.join(outdir, "surface.npz"), v=v, a=a, dadt=dadt)


def test_run_study_validated_selects_same_checkpoint(tmp_path, monkeypatch):
    spec_j = replace(JSt.D2, step_size=10)
    spec_t = replace(TSt.D2, step_size=10)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    for out in (out_j, out_t):
        _write_surface(out)
    nets = {s: np_net(10 + s, n_layers=1, n_nodes=16, std=0.05)
            for s in range(2)}
    monkeypatch.setattr(JSt, "init_params", lambda spec, key=None: (
        JN.NNdParams(jax_net(nets[spec.init_seed]), spec.base_hh)))
    monkeypatch.setattr(TSt, "init_params", lambda spec, generator=None,
                        device=None: TN.NNdParams(
                            TN.MLP(torch_net(nets[spec.init_seed])),
                            spec.base_hh))
    rs = np.random.RandomState(5)
    xv = np.stack([rs.uniform(-1.2, 0.4, 64), rs.uniform(0.05, 0.95, 64)],
                  axis=-1).astype(np.float32)
    yv = rs.uniform(-1e-3, 1e-3, 64).astype(np.float32)
    offsets = [float("inf"), 0.3, 0.0, 0.2]   # seed 0 iter 10 "diverged"
    seen = {"jax": [], "torch": []}

    def metric(side, loss_fn, x, y):
        def score(spec, params):
            k = len(seen[side])
            s = offsets[k] + float(loss_fn(params.net, x, y))
            seen[side].append((spec.init_seed, s))
            return {"pr3": s, "score": s}
        return score

    kw = dict(n_seeds=2, iters=20, val_every=10, cached=True)
    pj = JSt.run_study_validated(spec_j, out_j, metric=metric(
        "jax", JT.surface_loss, jnp.asarray(xv), jnp.asarray(yv)), **kw)
    pt = TSt.run_study_validated(spec_t, out_t, metric=metric(
        "torch", TT.surface_loss, torch.from_numpy(xv), torch.from_numpy(yv)),
        device="cpu", **kw)
    assert [s for s, _ in seen["torch"]] == [s for s, _ in seen["jax"]] \
        == [0, 0, 1, 1]
    assert_close([v for _, v in seen["torch"]], [v for _, v in seen["jax"]],
                 atol=0.0, rtol=SCORE_RTOL)
    # the kept checkpoint (seed 1, iteration 10) in both, and on disk
    assert int(np.argmin([v for _, v in seen["jax"]])) == 2
    saved = JC.load_pytree(os.path.join(out_t, "model.npz"), pj)
    for (w, _), (wj, _), (ws, _) in zip(pt.net.layers, pj.net, saved.net):
        assert_close(w, wj, atol=1e-4)
        np.testing.assert_array_equal(np_(w), np_(ws))
    assert os.path.exists(os.path.join(out_t, "model-entire.spec.json"))


def test_run_study_validated_refuses_debug(tmp_path):
    with pytest.raises(NotImplementedError, match="A12"):
        TSt.run_study_validated(TSt.D2, str(tmp_path), debug=True,
                                device="cpu")


# Stand-in recordings at 1 ms: (n_sweeps, period) for the multi-sweep ones
_SWEEPS = {"pr3-cell5": (2, 1500), "pr4-cell5": (16, 200),
           "pr5-cell5": (2, 1200)}


def _standin_voltage(name):
    if name in _SWEEPS:
        n_sw, period = _SWEEPS[name]
        level = {"pr3-cell5": 20.0, "pr4-cell5": 0.0, "pr5-cell5": 40.0}[name]
        sweep = np.full(period, -80.0)
        sweep[period // 8: period // 2] = level
        sweep[period // 2: 5 * period // 8] = -110.0
        return np.tile(sweep, n_sw), 1.0
    n = {"sinewave-cell5": 2000, "aps-cell5": 1800}[name]
    t = np.arange(n, dtype=np.float64)
    v = -80.0 + 60.0 * np.sin(2 * np.pi * t / 700.0) * (t > 200)
    return np.round(v, 3), 1.0


def test_table_rollout_maes_pop_bookkeeping(monkeypatch, capsys):
    """Three checkpoints (the second with NaN weights) in a batch of 4 (the
    last repeated): the finite rows' MAEs agree, the Pr4 column scores only
    sweeps 1-3, the non-finite row is rescored by the per-checkpoint path
    and scores inf in both packages, and the port reports it."""
    for rec in (JRec, TRec):
        monkeypatch.setattr(rec, "load_voltage", _standin_voltage)
        monkeypatch.setattr(rec, "SWEEPS", _SWEEPS)
        monkeypatch.setattr(rec, "PR4_N", 16 * 200)
    chain = dict(seg_samples=2048, chunk=512)
    monkeypatch.setattr(JE, "population_rollout_maes", functools.partial(
        JE.population_rollout_maes, interpret=True, **chain))
    monkeypatch.setattr(TSt, "population_rollout_maes", functools.partial(
        TSt.population_rollout_maes, **chain))
    # the same noisy targets in both packages' caches
    rs = np.random.RandomState(0)
    for _label, name, _yc in TSt._TABLE_COLS:
        gt = TSt._sim_real_table("markov", TR.MARKOV_B06, name, device="cpu")
        noisy = gt + 0.1 * rs.randn(gt.size)
        monkeypatch.setitem(JSt._GT_ROLLOUTS, JSt._gt_key(JSt.D2, name, True),
                            noisy)
        monkeypatch.setitem(TSt._GT_ROLLOUTS, TSt._gt_key(TSt.D2, name, True),
                            noisy)
    nets = [np_net(20 + k, n_layers=1, n_nodes=16) for k in range(3)]
    nets[1] = [(w * np.nan, b) for w, b in nets[1]]
    pj = [JN.NNdParams(jax_net(n), JR.HH_D2_BASE) for n in nets]
    pt = [TN.NNdParams(TN.MLP(torch_net(n)), TR.HH_D2_BASE) for n in nets]
    kw = dict(batch=4, trips=2048)
    want = JSt.table_rollout_maes_pop(JSt.D2, pj, **kw)
    got = TSt.table_rollout_maes_pop(TSt.D2, pt, **kw)
    assert "3 checkpoints at 2048 trips; 1 non-finite rows rescored" in \
        capsys.readouterr().out
    assert len(got) == len(want) == 3
    cols = ["pr3", "pr5", "pr4", "sin", "aps", "score"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(cols)
        assert_close([g[c] for c in cols], [w[c] for c in cols], atol=0.0,
                     rtol=MAE_RTOL)
    assert got[1]["score"] == float("inf")
    assert all(np.isfinite(got[k]["score"]) for k in (0, 2))
    # Pr4 scores sweeps 1-3 only: the per-checkpoint path agrees
    single = TSt.table_rollout_maes(TSt.D2, pt[2])
    assert_close([single[c] for c in cols], [got[2][c] for c in cols],
                 atol=0.0, rtol=MAE_RTOL)
