"""The d0 fit's other objectives in the port (scripts/train_d0_torch.py:
``make_objective`` (lockstep), ``make_objective_analytic``,
``make_objective_native``) against the JAX script's on test_torch_d0.py's
stand-in recordings, the port's objectives among themselves, and ``main``
with each of its paths on the CPU."""

import os

import numpy as np
import pytest
import torch

from test_torch_d0 import RECORDINGS, scripts, standin  # noqa: F401

POP = 4


def _candidates(T):
    rs = np.random.RandomState(5)
    xs = T.P0[None] * np.exp(0.1 * rs.randn(POP, 4))
    xs[0] = T.P0
    return xs


@pytest.fixture
def data(standin, tmp_path):  # noqa: F811
    J, T = standin
    d = T.generate_data(str(tmp_path / "port"), device="cpu",
                        recordings=RECORDINGS)
    return J, T, d


def test_lockstep_objective_matches_jax(data):
    """Lockstep: the same adaptive controller in both packages; their f32
    step sequences part at round-off (FMA contraction and exp rounding), so
    the dense output differs at the step edges: 1e-3 relative on the SSE."""
    J, T, (d3, d5) = data
    xs = _candidates(T)
    f_t = T.make_objective(d3, d5, POP, device="cpu",
                           recordings=RECORDINGS)(xs)
    f_j = J.make_objective(d3, d5, POP)(xs)
    assert f_t.dtype == np.float64 and f_t.shape == (POP,)
    assert np.all(np.isfinite(f_t))
    np.testing.assert_allclose(f_t, f_j, rtol=1e-3)


def test_analytic_objective_matches_jax(data):
    """Analytic: the same closed forms; the segment-start states are
    composed in another order (a loop, not JAX's tree) and the sums run in
    another order: 1e-5 relative."""
    J, T, (d3, d5) = data
    xs = _candidates(T)
    obj = T.make_objective_analytic(d3, d5, POP, device="cpu",
                                    recordings=RECORDINGS)
    f_t = obj(xs)
    f_j = J.make_objective_analytic(d3, d5, POP)(xs)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5)
    out = obj.device_fn(torch.from_numpy(xs.astype(np.float32)))
    assert np.array_equal(out.numpy().astype(np.float64), f_t)
    # a wild candidate overflows its rate and scores inf alone
    wild = xs.copy()
    wild[1, 1] = 60.0
    f_w = obj(wild)
    assert np.isinf(f_w[1]) and np.all(np.isfinite(f_w[[0, 2, 3]]))
    np.testing.assert_array_equal(np.isinf(J.make_objective_analytic(
        d3, d5, POP)(wild)), np.isinf(f_w))


def test_native_objective_matches_jax_bit_for_bit(data, monkeypatch):
    """The same C++ source built with the same flags: equal bit for bit."""
    J, T, (d3, d5) = data
    names = {"pr3-cell5": RECORDINGS[0], "pr5-cell5": RECORDINGS[1]}
    monkeypatch.setattr(J.protorec, "load_voltage",
                        lambda name: (names[name][1], names[name][2]))
    xs = _candidates(T)[:2]
    f_t = T.make_objective_native(d3, d5, recordings=RECORDINGS)(xs)
    f_j = J.make_objective_native(d3, d5)(xs)
    assert np.all(np.isfinite(f_t))
    assert np.array_equal(f_t, f_j)


def _standin_at_rest(seed, period):
    """3 sweeps of `period` knots at 2 ms whose last 3.8 s or more hold -80
    mV: the a-gate (tau ~370 ms there) is back at rest when a sweep ends."""
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(3):
        levels = [-80.0, *rs.uniform(-100.0, 40.0, 2), -80.0]
        rows.append(np.repeat(levels, np.diff([0, 100, 600, 1100, period])))
    return np.concatenate(rows)


AT_REST = [("rest-a", _standin_at_rest(0, 3000), 2.0, 3, 3000),
           ("rest-b", _standin_at_rest(1, 2999), 2.0, 3, 2999)]


def test_port_objectives_agree(scripts):  # noqa: F811
    """Lockstep, analytic, fused and native SSEs within 1e-2 relative: four
    ways to the same trace (two adaptive f32 solves at rtol 1e-5, the exact
    propagator with its midpoint ramps, the f64 host solve).  On recordings
    whose sweeps end at rest, as the recorded Pr3 does: the native objective
    restarts the second recording from rest, as the reference package's
    does, where the others carry the candidate's state across."""
    _, T = scripts
    d3, d5 = T.generate_data(None, device="cpu", recordings=AT_REST)
    xs = _candidates(T)
    kw = dict(device="cpu", recordings=AT_REST)
    got = {
        "lockstep": T.make_objective(d3, d5, POP, **kw)(xs),
        "analytic": T.make_objective_analytic(d3, d5, POP, **kw)(xs),
        "fused": T.make_objective_fused(d3, d5, POP, **kw)(xs),
        "native": T.make_objective_native(
            d3, d5, recordings=AT_REST)(xs[:1]),
    }
    ref = got["analytic"]
    for name, f in got.items():
        np.testing.assert_allclose(f, ref[:f.size], rtol=1e-2,
                                   err_msg=name)


@pytest.mark.parametrize("flags, objective", [
    (["--debug"], "lockstep"),
    (["--analytic", "--debug"], "--analytic"),
    (["--myokit", "--debug"], "--myokit"),
    (["--onchip", "--max-iterations", "2"], "--onchip"),
])
def test_main_paths_on_cpu(scripts, tmp_path, monkeypatch, capsys,  # noqa: F811
                           flags, objective):
    """main() takes the JAX script's flags in its order; no flag is the
    lockstep objective; --onchip runs cmaes_onchip over the analytic one."""
    _, T = scripts
    short = [(n, v[:2 * p], dt, 2, p) for n, v, dt, _, p in RECORDINGS]
    monkeypatch.setattr(T, "RECORDINGS", short)
    outdir = tmp_path / "d0"
    assert T.main(["--device", "cpu", "--outdir", str(outdir)]
                  + flags) == 0
    out = capsys.readouterr().out
    assert "Initial guess error:" in out
    assert objective in out
    fitted = os.path.exists(outdir / "model-parameters.txt")
    assert fitted == ("--debug" not in flags)
    if fitted:
        assert "CMA-ES done: 2 iters, 16 evals" in out
        x = np.loadtxt(outdir / "model-parameters.txt")
        assert np.all(x >= 0.1 * T.P0) and np.all(x <= 10.0 * T.P0)
