"""ionflux_torch/figures.py against ionflux/figures.py: the numeric helpers
(mae_row, latex_table, cached_sim, the model loaders) and the plotting
helpers, and the module without matplotlib.

mae_row computes in the default dtype, as JAX's follows jax_enable_x64
(on in this test session, tests/conftest.py): with torch's default float64
(the drivers' --x64) the MAEs equal JAX's to 1e-15 and the LaTeX text is
equal byte for byte."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import figures as JF
from ionflux import protocols as JP
from ionflux.models import registry as JR
from ionflux_torch import figures as TF
from ionflux_torch import protocols as TP
from ionflux_torch import protorec as TRec
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR

import _replay_standins as RS
from _torch_helpers import np_, np_net, torch_net, ts_between_edges

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def float64_default():
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(torch.float32)


def _rows():
    rs = np.random.RandomState(0)
    truth = rs.randn(5000)
    preds = {k: truth + s * rs.randn(5000)
             for k, s in (("Original", 0.4), ("NN-f", 0.11), ("NN-d", 0.2))}
    return truth, preds


def test_mae_row_and_latex_table_equal_jax(tmp_path, float64_default):
    truth, preds = _rows()
    got, want = TF.mae_row(truth, preds), JF.mae_row(truth, preds)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-15, atol=0.0)
    assert TF._as_default(truth).dtype == torch.float64
    assert str(jnp.asarray(truth).dtype) == "float64"
    rows = {k: [v, v / 3, 2.0 / 3.0, "n/a", 7] for k, v in got.items()}
    header = ["Pr3", "Pr5", "Pr4", "Sinusoidal", "APs"]
    for caption in ("", "d-study MAE (nA); Pr4 (sweeps 1-3)"):
        pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
        TF.latex_table(pt, header, rows, caption=caption)
        JF.latex_table(pj, header, {k: list(v) for k, v in rows.items()},
                       caption=caption)
        with open(pt, "rb") as ft, open(pj, "rb") as fj:
            assert ft.read() == fj.read()


def test_mae_row_follows_the_default_dtype():
    """Without --x64 the port's MAEs are float32 sums: within 1e-6 of
    JAX's float64 ones, but not equal to them."""
    truth, preds = _rows()
    got, want = TF.mae_row(truth, preds), JF.mae_row(truth, preds)
    assert TF._as_default(truth).dtype == torch.float32
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-6)
    assert list(got.values()) != list(want.values())


def test_cached_sim_matches_jax_and_reads_its_cache(tmp_path):
    """An HH current on a 2 s step through both packages' cached_sim, at
    output times 50 ms or more from an edge: within 1e-5 of the range
    (ts_between_edges); a second call with cached=True reads the npz."""
    tp = TP.activation_protocol(20.0, dt_ms=1.0, device="cpu")
    jp = JP.activation_protocol(20.0, dt_ms=1.0)
    ts = np.asarray(ts_between_edges(2000.0)[0], np.float64)
    dt_, dj = str(tmp_path / "t"), str(tmp_path / "j")
    yt = TF.cached_sim(dt_, "hh", False, "hh", TR.HH_B06, tp, ts, TR.TABLE1)
    yj = JF.cached_sim(dj, "hh", False, "hh", JR.HH_B06, jp, ts, JR.TABLE1)
    assert yt.dtype == np.float64 and yt.shape == (20,)
    rng = float(np.ptp(yj))
    assert rng > 0.1
    np.testing.assert_allclose(yt, yj, rtol=0.0, atol=1e-5 * rng)
    np.savez(os.path.join(dt_, "hh.npz"), y=np.arange(3.0))
    np.testing.assert_array_equal(
        TF.cached_sim(dt_, "hh", True, "hh", TR.HH_B06, tp, ts, TR.TABLE1),
        np.arange(3.0))


def _leaves_equal(port, ref) -> None:
    """A port model (kind, params, style) against JAX's."""
    kind, p, style = port
    kj, pj, sj = ref
    assert (kind, style) == (kj, sj)
    if kind == "hh":
        np.testing.assert_array_equal(np.asarray(p, np.float32),
                                      np.asarray(pj, np.float32))
        return
    assert len(p.net.layers) == len(pj.net)
    for (w, b), (wj, bj) in zip(p.net.layers, pj.net):
        np.testing.assert_array_equal(np_(w), np.asarray(wj))
        np.testing.assert_array_equal(np_(b), np.asarray(bj))
    np.testing.assert_array_equal(np.asarray(p[1], np.float32),
                                  np.asarray(pj[1], np.float32))


def test_model_loaders_equal_jax(tmp_path):
    """load_d_models and load_s_models on the committed out/: the same
    labels, kinds and styles, leaves equal; the archived-weights branch
    names the file it lacks."""
    out = os.path.join(ROOT, "out")
    for load_t, load_j in ((TF.load_d_models, JF.load_d_models),
                           (TF.load_s_models, JF.load_s_models)):
        got, want = load_t(out, device="cpu"), load_j(out)
        assert list(got) == list(want) == ["Original", "NN-f", "NN-d"]
        for label in got:
            _leaves_equal(got[label], want[label])
    with pytest.raises(FileNotFoundError, match="s1/model-state-dict.pt"):
        TF.load_s_models(None, refdir=str(tmp_path), device="cpu")
    empty = TF.load_d_models(str(tmp_path), device="cpu")
    assert list(empty) == ["Original"]


def _columns(names):
    cols = []
    for name in names:
        v, dt = RS.voltage(name)
        shape = RS.SWEEPS.get(name, (1, v.size))
        cols.append({
            "t": np.arange(shape[1]) * dt, "v": v.reshape(shape),
            "data": RS.trace(name, 0).reshape(shape),
            "preds": {lab: RS.trace(name, k).reshape(shape)
                      for k, lab in enumerate(RS.LABELS, 1)},
            "zooms": [(1000, 3000, -1, 4, TF.SET2[0]),
                      (4000, 4500, -5, 5, TF.SET2[1])]})
    return cols


def _is_png(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plotting_helpers_write_pngs(tmp_path, monkeypatch):
    """Each plotting helper draws: sweep_panel and zoom_inset on one axis,
    surface_scatter_3d with an NN-d net over its base, the figure-2 and
    figure-3 compositions (plot_sweep_panels, zoom_panel inside), and the
    figure-1 phase portraits solved on two short stand-in recordings."""
    plt = TF._pyplot()
    t = np.linspace(0.0, 100.0, 201)
    fig, ax = plt.subplots()
    TF.sweep_panel(ax, t, {"data": (np.sin(t), None),
                           "NN-f": (np.cos(t), "C1--")}, title="panel",
                   data_label="data")
    TF.zoom_inset(ax, t, {"data": (np.sin(t), None)}, (10, 20), (-1, 1))
    fig.savefig(tmp_path / "panel.png")
    plt.close(fig)
    rs = np.random.RandomState(0)
    net = TN.MLP(torch_net(np_net(0, n_layers=1, n_nodes=16)))
    TF.surface_scatter_3d(str(tmp_path / "rates3d.png"),
                          rs.uniform(-120, 40, 300), rs.uniform(0, 1, 300),
                          rs.randn(300) * 1e-3, net=net, nnd_base=TR.HH_B06)
    TF.fit_composition_cols(str(tmp_path / "cols.png"),
                            _columns(["pr3-cell5", "pr5-cell5"]))
    top, *rows = _columns(["pr4-cell5", "sinewave-cell5", "aps-cell5"])
    top["zooms"] = []
    TF.fit_composition_rows(str(tmp_path / "rows.png"), [top], rows)

    def short(name):
        n = {"sinewave-cell5": 3000, "aps-cell5": 2500}[name]
        tt = np.arange(n, dtype=np.float64)
        return np.where((tt > 500) & (tt < 1500), 10.0, -80.0), 0.1

    monkeypatch.setattr(TRec, "load_voltage", short)
    TF.phase_portrait_figure(
        str(tmp_path / "fig1.png"),
        [("sinewave-cell5", "#fdbb84", "Sinusoidal"),
         ("aps-cell5", "#bcbddc", "APs")], str(tmp_path), device="cpu")
    for name in ("panel", "rates3d", "cols", "rows", "fig1"):
        assert _is_png(str(tmp_path / f"{name}.png")), name
    a, z = TF.portrait_trajectories("gta", "aps-cell5", [0.0, 0.0],
                                    str(tmp_path), cached=True)
    assert a.shape == z.shape == (2500,) and float(a.max()) > 0.0


def test_figures_work_without_matplotlib(tmp_path):
    """With matplotlib blocked, ionflux_torch.figures imports, a drawing
    call raises ImportError naming matplotlib, and table_1_torch runs on
    pre-seeded caches."""
    out = str(tmp_path / "table")
    RS.seed_table_1(out)
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'scripts')!r}, "
        f"{os.path.join(ROOT, 'tests')!r}, {ROOT!r}]\n"
        "import ionflux_torch.figures as F\n"
        "try:\n"
        "    F.fit_composition_cols('x.png', [])\n"
        "except ImportError as exc:\n"
        "    assert 'matplotlib' in str(exc)\n"
        "else:\n"
        "    raise SystemExit('drew without matplotlib')\n"
        "import _replay_standins as RS\n"
        "from ionflux_torch import protorec\n"
        "protorec.load_voltage = RS.voltage\n"
        "protorec.SWEEPS = RS.SWEEPS\n"
        "import table_1_torch\n"
        "table = table_1_torch.main(['--cached', '--device', 'cpu', "
        f"'--outdir', {out!r}])\n"
        "assert sorted(table) == sorted(RS.COLS.values()), table\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.split('.')[0] in ('matplotlib', 'jax', 'ionflux')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
    with open(os.path.join(out, "table-1.txt")) as fh:
        text = fh.read()
    assert text.startswith("% d-study MAE (nA)") and "NN-d & 0." in text


def test_stage_timer_and_solves_per_sec_match_jax():
    """utils/timing.py against ionflux/utils/timing.py: the same stages and
    counts, the same report for the same totals; solves_per_sec counts
    n_solves x reps calls."""
    from ionflux.utils import timing as JTm
    from ionflux_torch.utils import timing as TTm

    tj, tt = JTm.StageTimer(), TTm.StageTimer()
    for timer, x in ((tj, jnp.ones(3)), (tt, torch.ones(3))):
        for name in ("solve", "solve", "score"):
            with timer.stage(name, sync=x):
                x = x * 2
        with pytest.raises(ValueError):
            with timer.stage("fails"):
                raise ValueError("inside a stage")
    assert dict(tt.counts) == dict(tj.counts) == {"solve": 2, "score": 1,
                                                  "fails": 1}
    for timer in (tj, tt):
        timer.totals.clear()
        timer.totals.update({"solve": 1.25, "score": 0.5, "fails": 2.0})
    assert tt.report() == tj.report()
    calls = []
    rate = TTm.solves_per_sec(lambda y: calls.append(1) or y * 2,
                              torch.ones(4), n_solves=8, reps=3)
    assert len(calls) == 4 and rate > 0.0
