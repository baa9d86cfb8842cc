"""The port's r-studies (ionflux_torch/rstudies.py) against the JAX
package's (ionflux/rstudies.py) on the short stand-in surface caches of
``_r_study_standins`` and narrowed nets (2 x 16) carried over from numpy
(``jax.random`` streams are not reproduced, so no fresh initialisation is
compared: ``init_params`` is patched in both packages where a runner draws
one).  Both packages' REFDIR point at the stand-in: the port's through
``studies.REFDIR``, JAX's through ``rstudies.REFDIR`` and, for
``predict_real_study``, which names the reference checkout's fixed path
itself (``JAX_REFDIR``), through its ``recover_measurements``, ``.pt``
reader and existence check with that prefix rewritten.

Tolerances: the Adam traces of the pretrain, 1e-3 relative
(test_torch_train.py's); the rollouts' MAEs, 2e-3 relative (two f32
adaptive solves, measured against JAX's float64 recovery here and the
port's float32)."""

import os
import re
from dataclasses import replace

import numpy as np
import pytest
import torch

import _r_study_standins as RS
import ionflux.realdata as JRD
from ionflux import protorec as JRec
from ionflux import rstudies as JS
from ionflux.models import nn as JN
from ionflux.utils import ckpt as JC
from ionflux_torch import protorec as TRec
from ionflux_torch import rstudies as TS
from ionflux_torch import studies as TSt
from ionflux_torch.models import nn as TN
from ionflux_torch.utils import ckpt as TC

from _torch_helpers import jax_net, np_, np_net, torch_net

RTOL = 1e-3
MAE_RTOL = 2e-3
JAX_REFDIR = JS.REFDIR      # the fixed checkout path of JAX's r-studies
NARROW = dict(n_layers=2, n_nodes=16)


def _fields(spec):
    return {k: (tuple(float(x) for x in v) if isinstance(v, tuple) else v)
            for k, v in spec.__dict__.items()}


@pytest.mark.parametrize("name", ["R1", "R2", "R1BAD", "s00", "s03", "s08"])
def test_specs_and_tune_study_equal(name):
    if name.startswith("s"):
        t, j = TS.tune_study(name), JS.tune_study(name)
    else:
        t, j = getattr(TS, name), getattr(JS, name)
    assert _fields(t) == _fields(j)
    assert sorted(TS.RSTUDIES) == sorted(JS.RSTUDIES)


def _pair(name: str, seed: int = 0):
    """(port spec, JAX spec, port params, JAX params): the narrowed study
    and one numpy-seeded net in both packages."""
    st = replace(getattr(TS, name), **NARROW)
    sj = replace(getattr(JS, name), **NARROW)
    leaves = np_net(seed, std=0.05 if name != "R2" else 1e-3, **NARROW)
    return (st, sj, TS.wrap_net(st, torch_net(leaves)),
            JS.wrap_net(sj, jax_net(leaves)))


def _surface(params_t, params_j, n=256):
    """Each net's output on one grid (the pretrain's input range)."""
    rs = np.random.RandomState(9)
    x = np.stack([rs.uniform(-1.4, 0.8, n), rs.uniform(-0.5, 1.5, n)], -1)
    out_t = np_(TN.mlp_apply(params_t.net if hasattr(params_t, "net")
                             else params_t, torch.as_tensor(
                                 x, dtype=torch.float32)))
    out_j = np.asarray(JN.mlp_apply(params_j.net if hasattr(params_j, "net")
                                    else params_j,
                                    np.asarray(x, np.float32)))
    return out_t, out_j


@pytest.mark.parametrize("name", ["R1", "R2"])
def test_pretrain_r_matches_jax(name):
    """1,000 Adam updates on the 100 x 100 analytic grid (NN-d through its
    residual): the pretrained nets' outputs within 1e-3 of their range, or
    of 1e-3 (1e-6 ms^-1 of da/dt) where the range is smaller (NN-d's
    residual pretrains towards 0)."""
    st, sj, pt, pj = _pair(name)
    net_t = TS.pretrain_r(st, pt.net)
    net_j = JS.pretrain_r(sj, pj.net)
    out_t, out_j = _surface(net_t, net_j)
    assert np.max(np.abs(out_t - out_j)) <= RTOL * max(np.ptp(out_j), 1e-3)


def test_rollout_health_matches_jax():
    st, sj, pt, pj = _pair("R1")
    (m_t, ok_t), (m_j, ok_j) = TS.rollout_health(st, pt), \
        JS.rollout_health(sj, pj)
    assert ok_t and ok_j
    assert m_t == pytest.approx(m_j, rel=MAE_RTOL)


@pytest.fixture
def refdir(monkeypatch, tmp_path):
    """The short stand-in caches (r1/, r1-bad/) and table-2 traces, both
    packages pointed at them."""
    RS.patch_short(monkeypatch, TRec, JRec)
    ref = str(tmp_path / "ref")
    RS.write_r_caches(ref)
    os.makedirs(f"{ref}/table-2")
    for tag in ("y1", "y2"):
        for name in ("sinewave", "aps"):
            n = RS.SINGLE[f"{name}-cell5"].size
            torch.save(torch.from_numpy(0.1 * np.sin(np.arange(n) / 50.0)),
                       f"{ref}/table-2/{tag}-{name}.pt")
    monkeypatch.setattr(TSt, "REFDIR", ref)
    monkeypatch.setattr(JS, "REFDIR", ref)
    # JAX's predict_real_study names JAX_REFDIR itself: its reader, its
    # existence check and recover_measurements see the stand-in there
    import ionflux.utils.ptload as JPT

    def moved(fn):
        return lambda p, *a, **k: fn(p.replace(JAX_REFDIR, ref), *a, **k)

    monkeypatch.setattr(JRD, "recover_measurements",
                        moved(JRD.recover_measurements))
    monkeypatch.setattr(JPT, "pt_load", moved(JPT.pt_load))
    monkeypatch.setattr(os.path, "exists", moved(os.path.exists))
    return ref


def test_real_validator_matches_jax(refdir):
    st, sj, pt, pj = _pair("R1")
    got = TS.RealValidator(st, device="cpu")(pt)
    want = JS.RealValidator(sj)(pj)
    assert list(got) == list(want) == ["pr5", "pr3"]
    for k in got:
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=MAE_RTOL)


def _patch_init(monkeypatch, pt, pj):
    monkeypatch.setattr(TS, "init_params",
                        lambda spec, generator=None, device=None: pt)
    monkeypatch.setattr(JS, "init_params", lambda spec, key=None: pj)


def _iter_lines(text: str):
    return [[float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?",
                                          ln)]
            for ln in text.splitlines() if ln.startswith("Iter ")]


@pytest.mark.parametrize("validated", [True, False])
def test_run_real_study_matches_jax(refdir, tmp_path, monkeypatch, capsys,
                                    validated):
    """Four updates after the pretrain on the stand-in r1 surface: with the
    stand-in reference the checkpoint is scored on Pr5 (RealValidator);
    with none named (the port's ReferenceMissing, JAX's missing file) it
    falls back to rollout-health selection.  The printed loss and score,
    and the kept nets, agree."""
    st, sj, pt, pj = _pair("R1")
    _patch_init(monkeypatch, pt, pj)
    surface = TS.load_reference_surface(st)
    assert all(np.array_equal(a, b) for a, b in
               zip(surface, JS.load_reference_surface(sj)))
    if not validated:
        monkeypatch.setattr(TSt, "REFDIR", None)
        monkeypatch.setattr(JS, "REFDIR", str(tmp_path / "absent"))
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    best_t = TS.run_real_study(st, out_t, iters=4, surface=surface,
                               device="cpu")
    text_t = capsys.readouterr().out
    best_j = JS.run_real_study(sj, out_j, iters=4, surface=surface)
    text_j = capsys.readouterr().out
    tag = "pr5 MAE" if validated else "rollout mean|I|"
    assert tag in text_t and tag in text_j
    if not validated:
        assert "real validation unavailable" in text_t
    (lt,), (lj,) = _iter_lines(text_t), _iter_lines(text_j)
    np.testing.assert_allclose(lt, lj, rtol=MAE_RTOL)
    out_t_, out_j_ = _surface(best_t, best_j)
    assert np.max(np.abs(out_t_ - out_j_)) <= RTOL * np.ptp(out_j_)
    for f in ("model.npz", "best-model.npz", "model-entire.npz",
              "checkpoint-2.json", "best-model-checkpoint-2.json"):
        assert os.path.exists(os.path.join(out_t, f))
    TC.load_pytree(os.path.join(out_t, "best-model.npz"), "nnf", "cpu")


def test_run_real_study_raises_on_a_validator_fault(refdir, tmp_path,
                                                    monkeypatch):
    """Only a missing reference falls back: any other fault while the
    validator is built (here a stand-in for a failed solve on the card)
    raises in the port, where the JAX package falls back silently."""
    st, sj, pt, pj = _pair("R1")
    _patch_init(monkeypatch, pt, pj)
    surface = TS.load_reference_surface(st)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(TS, "recover_measurements", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        TS.run_real_study(st, str(tmp_path / "port"), iters=4,
                          surface=surface, device="cpu")
    with pytest.raises(TS.ReferenceMissing):
        monkeypatch.setattr(TSt, "REFDIR", None)
        TS.RealValidator(st, device="cpu")


@pytest.mark.parametrize("name", ["R1", "R2"])
def test_predict_real_study_matches_jax(refdir, tmp_path, capsys, name):
    """The --pred replay of a checkpoint written once (the shared npz
    layout): Pr3, Pr5 and Pr4 against the recovered measurements, the
    sinewave and APs rows against the stand-in table-2 traces."""
    st, sj, pt, pj = _pair(name)
    out = str(tmp_path / name)
    os.makedirs(out)
    JC.save_pytree(os.path.join(out, "best-model.npz"), pj)
    got = TS.predict_real_study(st, out, device="cpu")
    want = JS.predict_real_study(sj, out)
    assert list(got) == list(want) == ["pr3", "pr5", "pr4", "sinewave",
                                       "aps"]
    for k in got:
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=MAE_RTOL), k
    text = capsys.readouterr().out
    assert text.count("Pr5 prediction | Total Loss") == 2

