"""run_study and run_study_best_of (ionflux_torch/studies.py) against
ionflux/studies.py, on the stand-in reference checkout and shortened
protocols of tests/_s_study_standins.py.  Both take the same cached surface
and the same initial nets (``init_params`` patched in both packages); the
saved weights agree within 1e-4 (the Adam traces' tolerance,
test_torch_train.py), the printed losses and MAEs within MAE_RTOL."""

import os
from dataclasses import replace

import numpy as np
import pytest

from ionflux import studies as JSt
from ionflux.models import nn as JN
from ionflux.utils import ckpt as JC
from ionflux_torch import studies as TSt
from ionflux_torch.models import nn as TN

from _s_study_standins import standin_checkout
from _torch_helpers import assert_close, jax_net, np_, np_net, torch_net

MAE_RTOL = 2e-3
# nA: run_study's AP2Hz line.  A pretrained NN-f scores ~2e-3 nA there, so
# the two solves' round-off parting (~1e-5 nA) is a few 1e-3 of it
AP2HZ_ATOL = 2e-5


@pytest.fixture
def standin(tmp_path, monkeypatch):
    return standin_checkout(tmp_path, monkeypatch)


def _write_surface(outdir, n=400, seed=0):
    """A small cached surface.npz (v mV, a, dadt) near HH_B06's a-gate,
    with a few points outside 0 < a < 1 that the runners drop."""
    rs = np.random.RandomState(seed)
    v = rs.uniform(-120.0, 40.0, n)
    a = rs.uniform(-0.1, 1.1, n)
    p = JSt.S1.rgate
    dadt = (float(p.p1) * np.exp(float(p.p2) * v) * (1 - a)
            - float(p.p3) * np.exp(-float(p.p4) * v) * a)
    os.makedirs(outdir, exist_ok=True)
    np.savez(os.path.join(outdir, "surface.npz"), v=v, a=a, dadt=dadt)


def _patch_init(monkeypatch, kind, nets):
    wrap_j = JN.NNfParams if kind == "nnf" else JN.NNdParams
    wrap_t = TN.NNfParams if kind == "nnf" else TN.NNdParams

    def base(spec):
        return spec.rgate if kind == "nnf" else spec.base_hh

    monkeypatch.setattr(JSt, "init_params", lambda spec, key=None: wrap_j(
        jax_net(nets[spec.init_seed]), base(spec)))
    monkeypatch.setattr(TSt, "init_params", lambda spec, generator=None,
                        device=None: wrap_t(
                            TN.MLP(torch_net(nets[spec.init_seed])),
                            base(spec)))


def _losses(text: str, tag: str) -> list[float]:
    return [float(ln.split()[-1]) for ln in text.splitlines()
            if ln.startswith(tag)]


def test_run_study_matches_jax(standin, tmp_path, monkeypatch, capsys):
    """run_study on S1 (pretrain, then Adam on the surface) and on S2 (the
    residual target, the s1 net's "Target Loss"): the saved weights within
    1e-4 of JAX's, the printed losses and the AP2Hz line within
    MAE_RTOL."""
    nets = {0: np_net(11, n_layers=1, n_nodes=16)}
    for kind, spec_name in (("nnf", "S1"), ("nnd", "S2")):
        _patch_init(monkeypatch, kind, nets)
        spec_j = replace(getattr(JSt, spec_name), pretrain_iters=30,
                         step_size=10)
        spec_t = replace(getattr(TSt, spec_name), pretrain_iters=30,
                         step_size=10)
        out_j = str(tmp_path / f"{spec_name}-jax")
        out_t = str(tmp_path / f"{spec_name}-torch")
        for out in (out_j, out_t):
            _write_surface(out)
        target = np_net(12, n_layers=1, n_nodes=16)
        tj = jax_net(target) if kind == "nnd" else None
        tt = TN.MLP(torch_net(target)) if kind == "nnd" else None
        pj = JSt.run_study(spec_j, out_j, iters=20, cached=True,
                           target_net=tj)
        text_j = capsys.readouterr().out
        pt = TSt.run_study(spec_t, out_t, iters=20, cached=True,
                           target_net=tt, device="cpu")
        text_t = capsys.readouterr().out
        saved = JC.load_pytree(os.path.join(out_t, "model.npz"), pj)
        for (w, b), (wj, bj), (ws, _) in zip(pt.net.layers, pj.net,
                                            saved.net):
            assert_close(w, wj, atol=1e-4)
            assert_close(b, bj, atol=1e-4)
            np.testing.assert_array_equal(np_(w), np.asarray(ws))
        tags = ["train done", "Pretraining"] + (
            ["pretrain done"] if kind == "nnf" else ["Target Loss"])
        for tag in tags:
            got, want = _losses(text_t, tag), _losses(text_j, tag)
            assert len(got) == len(want) == 1, tag
            assert_close(got, want, atol=AP2HZ_ATOL, rtol=MAE_RTOL)
        assert os.path.exists(os.path.join(out_t, "model-entire.spec.json"))


def test_run_study_best_of_keeps_jax_seed(standin, tmp_path, monkeypatch,
                                          capsys):
    """run_study_best_of on S2 over two seeds: the same per-seed
    validation MAEs (within MAE_RTOL) and the same kept seed, whose weights
    are saved within 1e-4 of JAX's."""
    nets = {0: np_net(21, n_layers=1, n_nodes=16, std=0.3),
            1: np_net(22, n_layers=1, n_nodes=16, std=0.05)}
    _patch_init(monkeypatch, "nnd", nets)
    spec_j = replace(JSt.S2, step_size=10)
    spec_t = replace(TSt.S2, step_size=10)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    for out in (out_j, out_t):
        _write_surface(out)
    pj = JSt.run_study_best_of(spec_j, out_j, n_seeds=2, iters=10,
                               cached=True)
    text_j = capsys.readouterr().out
    pt = TSt.run_study_best_of(spec_t, out_t, n_seeds=2, iters=10,
                               cached=True, device="cpu")
    text_t = capsys.readouterr().out
    got = [float(ln.split()[-1]) for ln in text_t.splitlines()
           if ln.startswith("seed ")]
    want = [float(ln.split()[-1]) for ln in text_j.splitlines()
            if ln.startswith("seed ")]
    assert len(got) == len(want) == 2 and got[0] != got[1]
    assert_close(got, want, atol=0.0, rtol=MAE_RTOL)
    saved = JC.load_pytree(os.path.join(out_t, "model.npz"), pj)
    for (w, _), (wj, _), (ws, _) in zip(pt.net.layers, pj.net, saved.net):
        assert_close(w, wj, atol=1e-4)
        np.testing.assert_array_equal(np_(w), np.asarray(ws))
    assert "kept validation-best model" in text_t
