"""The --oracle branches of the d-study replay drivers
(scripts/table_1_torch.py, figure_2_torch.py, figure_3_torch.py) and
``figures.load_d_models_reference``, on a stand-in checkout whose
d1/, d2/model-state-dict.pt hold the committed out/d1, out/d2 nets
(``_r_replay_standins``).

``load_d_models_reference`` gives JAX's parameters bit for bit.  Table 1's
--oracle table runs against the JAX script (scripts/table_1.py --oracle,
its ``load_d_models_reference`` pointed at the stand-in), both from
pre-seeded trace caches on the stand-in recordings of ``_replay_standins``
with JAX's noise copied across, as test_torch_replay_drivers.py does: the
text equal byte for byte.  Figures 2 and 3 draw the oracle trio from the
same caches as the default one: the same MAEs.  Without the files, each
raises FileNotFoundError naming the file."""

import os
import runpy
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ionflux.figures as JF
from ionflux import protorec as JRec
from ionflux.observe import add_noise as j_add_noise
from ionflux_torch import figures as TF
from ionflux_torch import protorec as TRec
from ionflux_torch import studies as TSt

import _r_replay_standins as RR
import _replay_standins as RS
from _torch_helpers import np_

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture
def ref(monkeypatch, tmp_path):
    """The stand-in checkout (d1/, d2/ state dicts), the port's REFDIR on
    it, the scripts importable; torch's default dtype restored after a
    --x64 run."""
    d = str(tmp_path / "ref")
    RR.write_state_dicts(d)
    monkeypatch.setattr(TSt, "REFDIR", d)
    monkeypatch.syspath_prepend(SCRIPTS)
    yield d
    torch.set_default_dtype(torch.float32)


def test_load_d_models_reference_gives_jax_parameters(ref, tmp_path):
    got = TF.load_d_models_reference(device="cpu")
    want = JF.load_d_models_reference(ref)
    assert list(got) == list(want) == ["Original", "NN-f", "NN-d"]
    for label, (kind, p, style) in got.items():
        kj, pj, sj = want[label]
        assert (kind, style) == (kj, sj)
        if kind == "hh":
            assert tuple(map(float, p)) == tuple(map(float, pj))
            continue
        for (w, b), (wj, bj) in zip(p.net.layers, pj.net):
            np.testing.assert_array_equal(np_(w), np.asarray(wj))
            np.testing.assert_array_equal(np_(b), np.asarray(bj))
        np.testing.assert_array_equal(np.asarray(p[1], np.float32),
                                      np.asarray(pj[1], np.float32))
    with pytest.raises(FileNotFoundError, match="d1/model-state-dict.pt"):
        TF.load_d_models_reference(str(tmp_path), device="cpu")


def _seed_oracle(out: str) -> None:
    """The oracle table's caches: other traces than the default's."""
    for name, col in RS.COLS.items():
        for k, label in enumerate(RS.LABELS, 4):
            RS.write(os.path.join(out, f"{col}-table-1-oracle.txt-{label}"
                                       ".npz"), y=RS.trace(name, k))


def test_table_1_oracle_equals_the_jax_script(ref, tmp_path, monkeypatch):
    import table_1_torch as T1

    RS.patch(monkeypatch, JRec, TRec)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    for out in (out_j, out_t):
        RS.seed_table_1(out)
        _seed_oracle(out)
    noise = {}
    for seed, (col, _name, _yc, _sl) in enumerate(T1.COLUMNS):
        with np.load(os.path.join(out_j, f"{col}-gt.npz")) as z:
            noise[seed] = np.asarray(j_add_noise(jax.random.PRNGKey(seed),
                                                 jnp.asarray(z["y"])),
                                     np.float64)
    monkeypatch.setattr(T1, "noisy", lambda truth, seed, device: noise[seed])
    orig = JF.load_d_models_reference
    monkeypatch.setattr(JF, "load_d_models_reference",
                        lambda refdir=None: orig(ref))
    monkeypatch.setattr(sys, "argv", ["table_1.py", "--oracle", "--cached",
                                      "--platform", "cpu", "--outdir",
                                      out_j])
    runpy.run_path(os.path.join(SCRIPTS, "table_1.py"), run_name="table_1")
    table = T1.main(["--oracle", "--cached", "--device", "cpu", "--x64",
                     "--outdir", out_t])
    for name in ("table-1.txt", "table-1-oracle.txt"):
        with open(os.path.join(out_t, name), "rb") as ft, \
                open(os.path.join(out_j, name), "rb") as fj:
            assert ft.read() == fj.read(), name
    assert list(table) == [c[0] for c in T1.COLUMNS] + ["oracle"]
    assert list(table["oracle"]) == list(table)[:-1]
    assert table["oracle"] != {k: v for k, v in table.items()
                               if k != "oracle"}
    monkeypatch.setattr(TSt, "REFDIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="d1/model-state-dict.pt"):
        T1.main(["--oracle", "--cached", "--device", "cpu", "--outdir",
                 out_t])


@pytest.mark.parametrize("driver, names, stem", [
    ("figure_2_torch", ["pr3-cell5", "pr5-cell5"], "fig2"),
    ("figure_3_torch", ["pr4-cell5", "sinewave-cell5", "aps-cell5"],
     "fig3")])
def test_figure_oracle_draws_the_reference_trio(ref, tmp_path, monkeypatch,
                                                driver, names, stem):
    mod = __import__(driver)
    RS.patch(monkeypatch, TRec)
    out = str(tmp_path / stem)
    RS.seed_figure(out, names)
    for name in names:      # the oracle trio's caches: the same traces
        for label in RS.LABELS:
            shutil.copy(os.path.join(out, f"{name}-{label}.npz"),
                        os.path.join(out, f"{name}-{label}-oracle.npz"))
    flags = ["--cached", "--device", "cpu", "--outdir", out]
    default = mod.main(flags)
    oracle = mod.main(["--oracle"] + flags)
    assert oracle == default
    assert os.path.exists(os.path.join(out, f"{stem}-oracle.png"))
    monkeypatch.setattr(TSt, "REFDIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="d1/model-state-dict.pt"):
        mod.main(["--oracle"] + flags)
