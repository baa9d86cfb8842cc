"""The r0-bad CMA-ES fit of the port (scripts/train_r0_bad_torch.py) against
the JAX script (scripts/train_r0_bad.py) on the short stand-in r1-bad cache
of ``_r_study_standins``: the per-sweep protocols and constants, the four
objectives' SSEs at population 3 (JAX's fused objective with its Pallas
kernel in interpret mode, 2,048 trips), the port's objectives among
themselves, the stand-in's truth, and ``main`` with its paths on the CPU.

The measurements are the port's float64 recovery from the stand-in cache,
handed to both scripts."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import _r_study_standins as RS
from ionflux import protorec as JRec
from ionflux.ops import pallas_solve as JK
from ionflux_torch import protorec as TRec
from ionflux_torch import realdata as TRD
from ionflux_torch import studies as TSt
from ionflux_torch.models import registry as TReg
from ionflux_torch.ops import hh_solve as TH

from _torch_helpers import np_

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
POP = 3


@pytest.fixture
def scripts(monkeypatch, tmp_path):
    """(the JAX script, the port's script, the measurements) on the short
    stand-ins.  The JAX script parses its arguments and makes its output
    directory when it is imported."""
    monkeypatch.syspath_prepend(SCRIPTS)
    monkeypatch.setenv("IONFLUX_SKIP_TPU_PROBE", "1")
    monkeypatch.setattr(sys, "argv", ["train_r0_bad.py", "--platform", "cpu",
                                      "--outdir", str(tmp_path / "jax")])
    import train_r0_bad as J
    import train_r0_bad_torch as T

    RS.patch_short(monkeypatch, TRec, JRec)
    ref = str(tmp_path / "ref")
    RS.write_r_caches(ref)
    monkeypatch.setattr(TSt, "REFDIR", ref)
    meas = TRD.recover_measurements(
        f"{ref}/r1-bad", TReg.CELL5_R1BAD, TReg.HH_R1BAD_INIT,
        protocols=("pr3", "pr4"), n_points=30, dtype=torch.float64,
        device="cpu")
    monkeypatch.setattr(JK, "fused_hh_pop_solve_ft", functools.partial(
        JK.fused_hh_pop_solve_ft, interpret=True))
    return J, T, meas


def _candidates(T):
    rs = np.random.RandomState(4)
    xs = T.P0[None] * np.exp(0.1 * rs.randn(POP, 4))
    xs[0] = T.P0
    return xs


def test_constants_and_sweep_protos_equal(scripts):
    J, T, _ = scripts
    assert np.array_equal(T.P0, J.P0)
    assert (T.G, T.E, T.RGATE) == (J.G, J.E, J.RGATE)
    for name in ("pr3-cell5", "pr4-cell5"):
        pj, tsj, n_j, per_j = J._sweep_protos(name)
        pt, tst, n_t, per_t = T._sweep_protos(name, device="cpu")
        assert (n_t, per_t) == (n_j, per_j) == (2, RS.SHORT[name][1])
        for a, b in zip(pt, pj):
            assert np.array_equal(np_(a), np.asarray(b))
        assert np.array_equal(np_(tst), np.asarray(tsj))


def test_fused_lattice_pads_with_repeats_and_ends_at_t_end():
    """Sweep 0 holds 3 lattice points, sweep 1 one: the short sweep repeats
    its last time and is masked there; the last column is period * dt."""
    sys.path.insert(0, SCRIPTS)
    try:
        import train_r0_bad_torch as T
    finally:
        sys.path.remove(SCRIPTS)
    idx = np.array([2, 5, 9, 13])
    d = np.arange(4, dtype=np.float32)
    v_full = np.linspace(-80.0, 20.0, 20)
    ts, v, dd, m = T._fused_lattice(idx, d, v_full, 2, 10, 0.1)
    loc = np.float32([[2, 5, 9], [3, 3, 3]])
    assert ts.dtype == np.float32
    np.testing.assert_array_equal(ts[:, :3], loc * 0.1)
    np.testing.assert_array_equal(ts[:, 3], np.float32(10 * 0.1))
    np.testing.assert_array_equal(m, [[True] * 3, [True, False, False]])
    np.testing.assert_array_equal(dd, [[0, 1, 2], [3, 0, 0]])
    np.testing.assert_array_equal(v[1, :1], np.float32(v_full[13:14]))


@pytest.mark.parametrize("path, rtol", [
    ("lockstep", 5e-3), ("analytic", 1e-5), ("fused", 5e-3),
    ("native", 0.0)])
def test_objective_matches_jax(scripts, path, rtol):
    """Lockstep and fused: the same adaptive controllers, whose f32 step
    sequences part at round-off and then cross the 0.1 ms step ramps with
    different luck (2.2e-3 relative measured: the short stand-in has an
    edge every ~50 ms, where d0's test recordings part by 1e-3); analytic:
    the same closed forms summed in another order (1e-5); native: the same
    C++ source (bit for bit)."""
    J, T, meas = scripts
    xs = _candidates(T)
    if path == "native":
        f_t = T.make_objective_native(meas)(xs[:2])
        f_j = J.make_objective_native(meas)(xs[:2])
        assert np.array_equal(f_t, f_j)
        return
    make_t = {"lockstep": T.make_objective,
              "analytic": T.make_objective_analytic,
              "fused": T.make_objective_fused}[path]
    make_j = {"lockstep": J.make_objective,
              "analytic": J.make_objective_analytic,
              "fused": J.make_objective_fused}[path]
    launches = TH.fused_hh_pop_solve_ft.launches
    obj = make_t(meas, POP, device="cpu")
    f_t = obj(xs)
    assert TH.fused_hh_pop_solve_ft.launches == launches   # CPU: plain
    f_j = make_j(meas, POP)(xs)
    assert f_t.dtype == np.float64 and f_t.shape == (POP,)
    assert np.all(np.isfinite(f_t))
    np.testing.assert_allclose(f_t, f_j, rtol=rtol)
    out = obj.device_fn(torch.from_numpy(xs.astype(np.float32)))
    assert np.array_equal(np_(out).astype(np.float64), f_t)


def test_port_objectives_agree_and_truth_fits(scripts):
    """The lockstep and fused objectives within 1e-2 relative of the
    analytic one (the native one restarts Pr4 from rest, as JAX's does,
    and the short stand-in's Pr3 ends 60 ms after its last step, not at
    rest: another trace, held to JAX's above), and the stand-in's
    generating parameters score below 1e-3 of P0's SSE."""
    _, T, meas = scripts
    xs = _candidates(T)
    ana = T.make_objective_analytic(meas, POP, device="cpu")
    got = {"lockstep": T.make_objective(meas, POP, device="cpu")(xs),
           "fused": T.make_objective_fused(meas, POP, device="cpu")(xs)}
    ref = ana(xs)
    for name, f in got.items():
        np.testing.assert_allclose(f, ref[:f.size], rtol=1e-2, err_msg=name)
    f_truth, f_p0 = ana(np.stack([RS.R1BAD_TRUTH, T.P0]))[:2]
    assert f_truth < 1e-3 * f_p0


def test_simulate_fit_matches_jax(scripts):
    """The full traces of P0: each package's lockstep solve within 5e-3 of
    the range of the exact propagator's current on the 3 ms-masked
    samples (1.9e-3 measured for the port, 2.2e-5 for JAX on Pr3; 3.0e-4
    and 1.3e-4 on Pr4), and within 1e-2 of each other anywhere (edges
    included)."""
    J, T, _ = scripts
    from ionflux_torch import protocols as TP

    for name in ("pr3", "pr4"):
        i_t = T._simulate_fit(T.P0, name, device="cpu")
        i_j = J._simulate_fit(T.P0, name)
        assert i_t.dtype == np.float64 and i_t.shape == i_j.shape
        v, dt = TRec.load_voltage(f"{name}-cell5")
        exact = (T.G * RS.gate_trace(v, dt, T.P0, 0.0)
                 * RS.gate_trace(v, dt, T.RGATE, 1.0, rgate=True)
                 * (v - T.E))
        m, rng = TP.training_mask(v, 30), np.ptp(exact)
        for i in (i_t, i_j):
            assert np.max(np.abs(i - exact)[m]) <= 5e-3 * rng
        assert np.max(np.abs(i_t - i_j)) <= 1e-2 * rng


@pytest.mark.parametrize("flags, objective", [
    (["--debug"], "lockstep"),
    (["--fused", "--debug"], "--fused"),
    (["--analytic", "--max-iterations", "2"], "--analytic"),
    (["--onchip", "--max-iterations", "2"], "--onchip"),
])
def test_main_paths_on_cpu(scripts, tmp_path, capsys, flags, objective):
    """main() takes the JAX script's flags in its order; it reads
    REFDIR/r1-bad, and a fit writes model-parameters.txt and report.json
    with the objective at the archived r0-bad fit."""
    _, T, _ = scripts
    out = tmp_path / "r0"
    report = T.main(["--device", "cpu", "--outdir", str(out)] + flags)
    text = capsys.readouterr().out
    assert "Initial guess error:" in text and objective in text
    if "--fused" in flags:
        assert "kernel launches per evaluation: 0" in text
    if "--debug" in flags:
        assert report is None
        assert not os.path.exists(out / "model-parameters.txt")
        return
    assert "CMA-ES done: 2 iters, 16 evals" in text
    x = np.loadtxt(out / "model-parameters.txt")
    assert np.all(x >= 0.1 * T.P0) and np.all(x <= 10.0 * T.P0)
    with open(out / "report.json") as fh:
        saved = json.load(fh)
    assert saved == report and np.isfinite(saved["sse_reference_params"])


def test_main_debug_matches_jax(scripts, tmp_path, monkeypatch, capsys):
    """Both drivers' main() with --analytic --debug on the stand-in r1-bad
    cache (JAX's through its module global REFDIR; its recovery in float64
    under the tests' x64, the port's with --x64): the same initial-guess
    error within 1e-5 relative, and JAX's data.png drawn."""
    J, T, _ = scripts
    ref = str(tmp_path / "ref")
    monkeypatch.setattr(J, "REFDIR", ref)
    os.makedirs(tmp_path / "jax", exist_ok=True)
    monkeypatch.setattr(J, "OUT", str(tmp_path / "jax"))
    monkeypatch.setattr(J.args, "analytic", True)
    monkeypatch.setattr(J.args, "debug", True)
    J.main()
    text_j = capsys.readouterr().out
    prev = torch.get_default_dtype()
    try:
        T.main(["--device", "cpu", "--analytic", "--debug", "--x64",
                "--outdir", str(tmp_path / "port")])
    finally:
        torch.set_default_dtype(prev)
    text_t = capsys.readouterr().out

    def f0(text):
        return float(text.split("Initial guess error:")[1].split()[0])

    assert f0(text_t) == pytest.approx(f0(text_j), rel=1e-5)
    assert os.path.exists(tmp_path / "jax" / "data.png")
