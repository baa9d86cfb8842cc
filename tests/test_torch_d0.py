"""The d0 whole-trace CMA-ES fit of the port (scripts/train_d0_torch.py)
against the JAX script (scripts/train_d0.py, its --fused objective with the
Pallas kernel in interpret mode): the score lattice, the per-sweep protocols,
and the whole path (data generation, the SSE objective, two CMA-ES
generations) on small stand-in recordings."""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import protocols as JP
from ionflux.ops import pallas_solve as JK
from ionflux_torch.fit.cmaes import cmaes
from ionflux_torch.ops import hh_solve as TH

from _torch_helpers import assert_close, np_

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


@pytest.fixture
def scripts(monkeypatch, tmp_path):
    """(the JAX script, the port's script).  The JAX script parses its
    arguments and makes its output directory when it is imported; whichever
    test imported it first, its outputs go to this test's tmp_path."""
    monkeypatch.syspath_prepend(SCRIPTS)
    monkeypatch.setattr(sys, "argv", ["train_d0.py", "--platform", "cpu",
                                      "--outdir", str(tmp_path)])
    import train_d0 as J
    import train_d0_torch as T

    monkeypatch.setattr(J, "OUT", str(tmp_path))
    monkeypatch.setattr(J.args, "cached", False)
    return J, T


def test_lattice_decomposition_equal(scripts):
    J, T = scripts
    assert T.SUB == J.SUB == 10
    for n_sweeps, period in ((7, 82580), (9, 103224), (4, 17), (2, 7)):
        got = T._lattice_decomposition(n_sweeps, period)
        want = J._lattice_decomposition(n_sweeps, period)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        idx, msk, counts = got
        flat = np.concatenate(
            [k * period + idx[k][msk[k]] for k in range(n_sweeps)])
        assert np.array_equal(flat, np.arange(0, n_sweeps * period, T.SUB))


@pytest.mark.parametrize("name", ["pr3-cell5", "pr5-cell5"])
def test_sweep_protos_and_constants_equal(scripts, name):
    J, T = scripts
    pj, tsj, n_j, period_j = J._sweep_protos(name)
    pt, tst, n_t, period_t = T._sweep_protos(name, device="cpu")
    assert (n_t, period_t) == (n_j, period_j)
    assert pt.v.dtype == torch.float32
    assert np.array_equal(np_(pt.v), np.asarray(pj.v))
    assert np.array_equal(np_(pt.dt), np.asarray(pj.dt))
    assert np.array_equal(np_(pt.t0), np.asarray(pj.t0))
    assert np.array_equal(np_(tst), np.asarray(tsj))
    assert np.array_equal(T.P0, J.P0)
    assert [float(x) for x in T.RGATE] == [float(x) for x in J.RGATE]


# Stand-in recordings: 2 protocols x 3 sweeps x ~2,000 knots at 1 ms; the
# second period is not a multiple of 10, so its lattice phase shifts.
def _standin(seed, period):
    rs = np.random.RandomState(seed)
    rows = []
    for _ in range(3):
        levels = [-80.0, *rs.uniform(-100.0, 40.0, 3), -80.0]
        cuts = np.linspace(0, period, 6).astype(int)
        rows.append(np.repeat(levels, np.diff(cuts)))
    return np.concatenate(rows)


RECORDINGS = [("standin-a", _standin(0, 2000), 1.0, 3, 2000),
              ("standin-b", _standin(1, 1999), 1.0, 3, 1999)]


def _jax_sweep_protos(name):
    """train_d0.py::_sweep_protos (its lines 96-107) on a stand-in."""
    _, v, dt, n_sweeps, period = RECORDINGS[
        {"pr3-cell5": 0, "pr5-cell5": 1}[name]]
    vs = np.empty((n_sweeps, period + 1), v.dtype)
    vs[:, :period] = v.reshape(n_sweeps, period)
    vs[:-1, period] = vs[1:, 0]
    vs[-1, period] = vs[-1, period - 1]
    protos = JP.stack([
        JP.Protocol(jnp.asarray(0.0, jnp.float32),
                    jnp.asarray(dt, jnp.float32),
                    jnp.asarray(row, jnp.float32)) for row in vs])
    ts = jnp.arange(period + 1, dtype=jnp.float32) * jnp.float32(dt)
    return protos, ts, n_sweeps, period


@pytest.fixture
def standin(scripts, monkeypatch):
    """Both scripts on the stand-in recordings: the JAX script through its
    own generate_data / make_objective_fused with its recordings swapped and
    its Pallas kernel in interpret mode."""
    J, T = scripts
    monkeypatch.setattr(J, "_sweep_protos", _jax_sweep_protos)
    monkeypatch.setattr(JK, "fused_hh_pop_solve_ft", functools.partial(
        JK.fused_hh_pop_solve_ft, interpret=True))
    return J, T


def test_d0_fit_on_standin_recordings(standin, tmp_path):
    J, T = standin
    # --- data: Markov ground truth + seed-0 noise on the [::10] lattice ----
    d_j = J.generate_data()
    d_t = T.generate_data(str(tmp_path / "port"), device="cpu",
                          recordings=RECORDINGS)
    assert [d.shape for d in d_t] == [(600,), (600,)]
    for a, b in zip(d_t, d_j):
        assert a.dtype == np.float64
        assert_close(a, b, atol=1e-4)
    again = T.generate_data(str(tmp_path / "port"), cached=True,
                            device="cpu", recordings=RECORDINGS)
    assert all(np.array_equal(a, b) for a, b in zip(again, d_t))

    # --- the SSE objective: 6 chained launches per evaluation --------------
    pop = 4
    obj_t = T.make_objective_fused(*d_t, pop, trips=2048, device="cpu",
                                   recordings=RECORDINGS)
    obj_j = J.make_objective_fused(*d_t, pop, trips=2048)
    rs = np.random.RandomState(2)
    xs = T.P0[None] * np.exp(0.1 * rs.randn(pop, 4))
    # a diverging candidate (k1 = p1 e^{10 V} overflows above 9 mV): its lane
    # dies and it scores inf alone (the dying lane pins the shared step for
    # some 800 trips first, so the budget is 2048, not 1024)
    assert max(v.max() for _, v, *_ in RECORDINGS) > 9.0
    xs[2, 1] = 10.0
    launches = TH.fused_hh_pop_solve_ft.launches
    f_t, f_j = obj_t(xs), obj_j(xs)
    assert TH.fused_hh_pop_solve_ft.launches == launches   # CPU: plain
    assert f_t.dtype == np.float64 and f_t.shape == (pop,)
    assert np.isinf(f_t[2]) and np.isinf(f_j[2])
    keep = [0, 1, 3]
    assert np.all(np.isfinite(f_t[keep]))
    np.testing.assert_allclose(f_t[keep], f_j[keep], rtol=1e-3)
    # fewer members than the population are padded with the last one (the
    # lanes share one step clock, so the score moves within tolerance), and
    # device_fn is the same function on tensors
    f_one = obj_t(xs[:1])
    assert f_one.shape == (1,)
    np.testing.assert_allclose(f_one[0], f_t[0], rtol=1e-3)
    out = obj_t.device_fn(torch.from_numpy(xs.astype(np.float32)))
    assert out.dtype == torch.float32
    assert np.array_equal(np_(out).astype(np.float64), f_t)

    # --- the fit takes two generations -------------------------------------
    res = cmaes(obj_t, T.P0, sigma0=0.1 * T.P0,
                bounds=(0.1 * T.P0, 10.0 * T.P0), popsize=pop,
                max_iterations=2)
    assert res.iterations == 2 and res.evaluations == 2 * pop
    assert res.hit_max_iterations and np.isfinite(res.fx)
    assert np.all(res.x >= 0.1 * T.P0) and np.all(res.x <= 10.0 * T.P0)


def test_generate_data_needs_whole_lattice_blocks(scripts):
    """Every recording but the last must hold a multiple of 10 samples, or
    the global [::10] lattice would not split per protocol."""
    _, T = scripts
    with pytest.raises(ValueError, match="multiple of 10"):
        T.generate_data(device="cpu", recordings=RECORDINGS[::-1])


def test_main_runs_debug_on_cpu(scripts, tmp_path, monkeypatch, capsys):
    """main() parses its own arguments (none at import) and stops after the
    initial guess with --debug; --fused takes the fused objective (with no
    flag main takes the lockstep one, as the JAX script does)."""
    _, T = scripts
    short = [(n, v[:2 * p], dt, 2, p) for n, v, dt, _, p in RECORDINGS]
    monkeypatch.setattr(T, "RECORDINGS", short)
    assert T.main(["--device", "cpu", "--fused", "--debug", "--outdir",
                   str(tmp_path / "d0")]) == 0
    out = capsys.readouterr().out
    assert "--fused" in out and "kernel launches per evaluation" in out
    assert "Initial guess error:" in out
    assert os.path.exists(tmp_path / "d0" / "data.npz")
    assert not os.path.exists(tmp_path / "d0" / "model-parameters.txt")
