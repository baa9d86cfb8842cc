"""The port's replay drivers (scripts/table_1_torch.py, figure_*_torch.py)
and the study drivers' --pred, --x64 and --trace flags.

table_1_torch runs against the JAX package's scripts/table_1.py, loaded with
its arguments patched (``--cached --platform cpu --outdir``) as
tests/test_torch_d0.py loads train_d0, on the same stand-in recordings and
pre-seeded trace caches (tests/_replay_standins.py); the two packages' noise
streams differ, so JAX's noise is copied across.  The table text is equal
byte for byte: JAX's MAEs are float64 in this test session
(tests/conftest.py turns on x64), the port's after --x64."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import protorec as JRec
from ionflux import studies as JSt
from ionflux.models import nn as JN
from ionflux.observe import add_noise as j_add_noise
from ionflux_torch import protorec as TRec
from ionflux_torch.models import nn as TN
from ionflux_torch.utils.ckpt import save_pytree

import _replay_standins as RS
from _s_study_standins import standin_checkout
from _torch_helpers import assert_close, jax_net, np_net, torch_net

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
MAE_RTOL = 2e-3


@pytest.fixture
def drivers(monkeypatch):
    """The port's scripts importable; torch's default dtype restored after
    a --x64 run."""
    monkeypatch.syspath_prepend(SCRIPTS)
    yield
    torch.set_default_dtype(torch.float32)


def _png(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_table_1_equals_the_jax_script(tmp_path, monkeypatch, drivers):
    import table_1_torch as T1

    RS.patch(monkeypatch, JRec, TRec)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    for out in (out_j, out_t):
        RS.seed_table_1(out)
    noise = {}
    for seed, (col, _name, _yc, _sl) in enumerate(T1.COLUMNS):
        with np.load(os.path.join(out_j, f"{col}-gt.npz")) as z:
            noise[seed] = np.asarray(j_add_noise(jax.random.PRNGKey(seed),
                                                 jnp.asarray(z["y"])),
                                     np.float64)
    monkeypatch.setattr(T1, "noisy", lambda truth, seed, device: noise[seed])
    monkeypatch.setattr(sys, "argv", ["table_1.py", "--cached", "--platform",
                                      "cpu", "--outdir", out_j])
    runpy.run_path(os.path.join(SCRIPTS, "table_1.py"), run_name="table_1")
    table = T1.main(["--cached", "--device", "cpu", "--x64", "--outdir",
                     out_t])
    with open(os.path.join(out_t, "table-1.txt"), "rb") as ft, \
            open(os.path.join(out_j, "table-1.txt"), "rb") as fj:
        text = ft.read()
        assert text == fj.read()
    assert list(table) == [c[0] for c in T1.COLUMNS]
    assert b"NN-f & " in text and text.count(b"\\\\") == 4


def test_figure_drivers_write_their_files(tmp_path, monkeypatch, drivers):
    """Figures 0-s (computed), 1 (and --s1, --s2), 2 and 3 (and --s) from
    pre-seeded caches on the stand-in recordings."""
    import figure_0_s_torch
    import figure_1_torch
    import figure_2_torch
    import figure_3_torch

    RS.patch(monkeypatch, TRec)
    runs = []
    for flag, names, png in (("", ["pr3-cell5", "pr5-cell5"], "fig1.png"),
                             ("--s1", ["pr3-cell5", "pr4-cell5"],
                              "fig1-s1.png"),
                             ("--s2", ["sinewave-cell5", "aps-cell5"],
                              "fig1-s2.png")):
        out = str(tmp_path / f"fig1{flag}")
        RS.seed_portraits(out, names)
        runs.append((figure_1_torch, [flag] if flag else [], out, png))
    for mod, names, stem in ((figure_2_torch, ["pr3-cell5", "pr5-cell5"],
                              "fig2"),
                             (figure_3_torch, ["pr4-cell5", "sinewave-cell5",
                                               "aps-cell5"], "fig3")):
        for s in (False, True):
            out = str(tmp_path / f"{stem}{'-s' if s else ''}")
            RS.seed_figure(out, names, s=s)
            runs.append((mod, ["--s"] if s else [], out,
                         f"{stem}{'-s' if s else ''}.png"))
    for mod, flags, out, png in runs:
        res = mod.main(flags + ["--cached", "--device", "cpu", "--outdir",
                                out])
        assert _png(os.path.join(out, png)), (mod.__name__, flags)
        if mod is not figure_1_torch:
            assert all(sorted(r) == sorted(RS.LABELS) and
                       all(np.isfinite(list(r.values())))
                       for r in res.values())
    out = str(tmp_path / "fig0s")
    t, noisy, i_smooth, didt = figure_0_s_torch.main(["--device", "cpu",
                                                      "--outdir", out])
    assert _png(os.path.join(out, "fig0s.png"))
    assert t.shape == noisy.shape == i_smooth.shape == didt.shape == (80001,)
    # the smoothed current leaves the 0.1 nA noise behind
    assert 0.07 < float(np.std(noisy - i_smooth)) < 0.13
    mid = (t > 2000) & (t < 5000)   # inside one segment of the step
    assert float(np.std(np.diff(i_smooth[mid]))) < 0.01 * float(
        np.std(np.diff(noisy[mid])))


@pytest.mark.parametrize("driver,spec,kind", [
    ("train_s1_torch", "S1", "nnf"), ("train_d2_torch", "D2", "nnd")])
def test_pred_replays_a_trained_model(tmp_path, monkeypatch, drivers, driver,
                                      spec, kind):
    """--pred replays <outdir>/model.npz through predict_study: the same
    MAEs as JAX's predict_study on the same net (within MAE_RTOL), on the
    stand-in checkout.  The s1 run adds --x64 (torch's default dtype
    float64 for the run, as jax_enable_x64 makes JAX's) and --trace (a
    profiler trace under <outdir>/trace/), on the first two cases."""
    import importlib

    from ionflux_torch import studies as TSt
    from ionflux_torch.figures import _as_default

    standin_checkout(tmp_path, monkeypatch)
    net = np_net(7, n_layers=1, n_nodes=16, std=0.2)
    ts_, js_ = getattr(TSt, spec), getattr(JSt, spec)
    if kind == "nnf":
        pt = TN.NNfParams(TN.MLP(torch_net(net)), ts_.rgate)
        pj = JN.NNfParams(jax_net(net), js_.rgate)
    else:
        pt = TN.NNdParams(TN.MLP(torch_net(net)), ts_.base_hh)
        pj = JN.NNdParams(jax_net(net), js_.base_hh)
    out = str(tmp_path / "out")
    os.makedirs(out)
    save_pytree(os.path.join(out, "model.npz"), pt)
    flags = ["--pred", "--device", "cpu", "--outdir", out]
    if kind == "nnf":
        flags += ["--x64", "--trace"]
        # the profiler records every op: replay the first two cases only
        for st in (JSt, TSt):
            monkeypatch.setattr(st, "prediction_cases", (
                lambda cases: lambda *a: cases(*a)[:2])(st.prediction_cases))
    got = importlib.import_module(driver).main(flags)
    want = JSt.predict_study(js_, pj)
    assert list(got) == list(want)
    assert_close(list(got.values()), list(want.values()), atol=0.0,
                 rtol=MAE_RTOL)
    if kind == "nnf":
        x = np.arange(3.0)
        assert torch.get_default_dtype() == torch.float64
        assert str(_as_default(x).dtype) == "torch." + str(
            jnp.asarray(x).dtype)
        trace = os.path.join(out, "trace", "trace.json")
        with open(trace) as fh:
            assert '"traceEvents"' in fh.read(4096)
