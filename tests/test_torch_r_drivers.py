"""The port's r-study drivers (scripts/train_r1_torch.py, train_r2_torch.py,
train_r1_bad_torch.py, train_r1_tune_torch.py) on the CPU, on the short
stand-in caches of ``_r_study_standins``: their flags against the JAX
scripts' (``scripts/common.py``'s ``study_parser(real=True)``), ``--pred``
of the committed out/r1 and out/r2 models (the same MAEs as
``rstudies.predict_real_study``), and short training runs."""

import os
import sys
from dataclasses import replace

import numpy as np
import pytest

import _r_study_standins as RS
from ionflux_torch import protorec as TRec
from ionflux_torch import rstudies as TS
from ionflux_torch import studies as TSt

from _torch_helpers import np_  # noqa: F401  (one torch thread a worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture
def drivers(monkeypatch, tmp_path):
    monkeypatch.syspath_prepend(SCRIPTS)
    RS.patch_short(monkeypatch, TRec)
    ref = str(tmp_path / "ref")
    RS.write_r_caches(ref)
    monkeypatch.setattr(TSt, "REFDIR", ref)
    return tmp_path


def _options(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


def test_real_flags_match_the_jax_scripts(drivers, monkeypatch):
    import common as J
    import common_torch as T

    got = _options(T.study_parser("x", real=True))
    want = _options(J.study_parser("x", real=True))
    assert {"--smoothi", "--info"} <= got
    assert got - {"--device"} == want - {"--platform"}
    assert not {"--smoothi", "--info"} & _options(T.study_parser("x"))


@pytest.mark.parametrize("script, spec", [("train_r1_torch", "R1"),
                                          ("train_r2_torch", "R2")])
def test_pred_replays_the_committed_model(drivers, capsys, script, spec):
    """--pred on out/<name> prints the reference's loss lines and returns
    predict_real_study's MAEs (the sinewave and APs rows skipped: the
    stand-in holds no table-2/)."""
    mod = __import__(script)
    name = getattr(TS, spec).name
    out = os.path.join(ROOT, "out", name)
    got = mod.main(["--pred", "--device", "cpu", "--outdir", out])
    text = capsys.readouterr().out
    assert list(got) == ["pr3", "pr5", "pr4"]
    assert all(np.isfinite(v) for v in got.values())
    for label in ("Pr3", "Pr5", "Pr4"):
        assert f"{label} prediction | Total Loss {got[label.lower()]:.6f}" \
            in text
    assert text.count("skipped") == 2


def test_r1_bad_trains_and_tune_sweeps_one_arch(drivers, monkeypatch,
                                                capsys):
    """r1-bad (narrowed to 1 x 8) and r1-tune's s03 (5 x 10): the pretrain
    and one 4-update chunk scored on the stand-in Pr5, into --outdir."""
    import train_r1_bad_torch as RB
    import train_r1_tune_torch as RT

    monkeypatch.setattr(TS, "R1BAD", replace(TS.R1BAD, n_layers=1,
                                             n_nodes=8))
    out = drivers / "r1-bad"
    params = RB.main(["--iters", "4", "--device", "cpu", "--outdir",
                      str(out)])
    assert params.net.layers[0][0].shape == (2, 8)
    assert (out / "best-model.npz").exists()
    out = drivers / "tune"
    res = RT.main(["--info", "s03", "--iters", "4", "--device", "cpu",
                   "--outdir", str(out)])
    assert list(res) == ["s03"]
    assert [tuple(w.shape) for w, _ in res["s03"].net.layers] == [
        (2, 10)] + [(10, 10)] * 5 + [(10, 1)]
    assert (out / "s03" / "model.npz").exists()
    text = capsys.readouterr().out
    assert text.count("pr5 MAE") == 2
    assert "=== architecture s03 (n_layers=5, n_nodes=10) ===" in text
    assert sys.modules["train_r1_tune_torch"] is RT


def test_real_data_scripts_import_neither_jax_nor_ionflux():
    """The real-data modules, drivers, probe and stand-in writer, imported
    in a fresh interpreter: neither jax, ionflux nor matplotlib is
    loaded."""
    import subprocess

    code = (
        "import sys\n"
        "sys.path[:0] = ['scripts', 'tests']\n"
        "import ionflux_torch.realdata, ionflux_torch.rstudies\n"
        "import ionflux_torch.ops.expfit, ionflux_torch.protorec\n"
        "import train_r1_torch, train_r2_torch, train_r1_bad_torch\n"
        "import train_r1_tune_torch, train_r0_bad_torch\n"
        "import _r_recovery_probe, _r_study_standins\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ionflux', 'matplotlib'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
