"""The port's table 2, table S1 and figure 7 drivers
(scripts/table_2_torch.py, table_s1_torch.py, figure_7_torch.py) and the
r-study loaders of ``figures`` on the CPU, each against the JAX package's
helpers composed in the JAX driver's order on the same stand-ins
(``_r_replay_world`` says which, and the tolerances)."""

import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest

from ionflux import eval as JE
from ionflux import figures as JF
from ionflux import rstudies as JS
from ionflux.models import registry as JR
from ionflux.utils import ckpt as JC
from ionflux.utils.ptload import pt_load
from ionflux_torch import figures as TF

from _r_replay_world import (GATE_MAX, GATE_MEDIAN, NARROW, close,  # noqa
                             jax_meas, jax_measured_maes, jax_sim,
                             lattice_idx, pr4_keep, run_driver, world)
from _torch_helpers import np_


# ---- the loaders ----------------------------------------------------------

def _same_params(p_t, p_j):
    for (w, b), (wj, bj) in zip(p_t.net.layers, p_j.net):
        np.testing.assert_array_equal(np_(w), np.asarray(wj))
        np.testing.assert_array_equal(np_(b), np.asarray(bj))
    np.testing.assert_array_equal(np.asarray(p_t[1], np.float32),
                                  np.asarray(p_j[1], np.float32))


@pytest.mark.parametrize("oracle", [False, True])
def test_load_r_models_gives_jax_parameters(world, oracle):
    """The trio from out/ or, with oracle, from the stand-in checkpoint
    (r1/best-model-checkpoint-2.pt's "state_dict") and state dict
    (r2/model-state-dict-2.pt): JAX's labels, kinds, constants and
    parameters, bit for bit."""
    got = TF.load_r_models(world["out"], oracle=oracle, refdir=world["ref"],
                           device="cpu")
    want = JF.load_r_models(world["out"], oracle=oracle,
                            refdir=world["ref"])
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for (_, kind, p_t, c_t), (_, _, p_j, c_j) in zip(got, want):
        assert tuple(map(float, c_t)) == tuple(map(float, c_j))
        if kind == "hh":
            assert tuple(map(float, p_t)) == tuple(map(float, p_j))
        else:
            _same_params(p_t, p_j)
    with pytest.raises(FileNotFoundError, match="r1/best-model-checkpoint"):
        TF.load_r_models(world["out"], oracle=True,
                         refdir=str(world["tmp"]), device="cpu")


def test_dense_measurement_equals_jax():
    rs = np.random.RandomState(0)
    idx = np.sort(rs.choice(np.arange(5, 900), 200, replace=False))
    idx = np.concatenate([idx, np.arange(950, 990, 7)])
    vals = rs.randn(idx.size)
    got = TF.dense_measurement(idx, vals, 1000)
    np.testing.assert_array_equal(got, JF.dense_measurement(idx, vals, 1000))
    assert np.isnan(got[:idx[0]]).all() and np.isnan(got[idx[-1] + 1:]).all()


# ---- the drivers ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_table_2(world):
    """JAX's table 2 on the stand-ins ({label: [5 MAEs]}), as
    scripts/table_2.py computes it."""
    meas = jax_meas(world["ref"])
    rows = {}
    for label, kind, params, c in JF.load_r_models(world["out"]):
        tag = {"Original": "yo", "NN-f": "y1", "NN-d": "y2"}[label]
        vals = jax_measured_maes(meas, kind, params, c)
        for name in ("sinewave", "aps"):
            ref_i = np.asarray(pt_load(
                f"{world['ref']}/table-2/{tag}-{name}.pt")).reshape(-1)
            vals.append(float(np.mean(np.abs(
                jax_sim(kind, params, name, c) - ref_i))))
        rows[label] = vals
    return rows


def test_table_2_matches_jax_and_oracle_equals_default(world, jax_table_2):
    got, outdir = run_driver(world, "table_2_torch")
    assert list(got) == list(jax_table_2) == ["Original", "NN-f", "NN-d"]
    for label in got:
        assert len(got[label]) == 5 and np.isfinite(got[label]).all()
        close(got[label], jax_table_2[label])
    assert os.path.exists(os.path.join(outdir, "table-2.txt"))
    # the stand-in state dicts hold out/'s nets: --oracle is the same table
    oracle, outdir = run_driver(world, "table_2_torch", "--oracle", sub="t2o")
    assert oracle == got
    assert os.path.exists(os.path.join(outdir, "table-2-oracle.txt"))


def test_figure_7_matches_jax_and_oracle_equals_default(world):
    got, outdir = run_driver(world, "figure_7_torch")
    params = JC.load_pytree(os.path.join(world["out"], "r1-bad",
                                         "model.npz"),
                            JS.init_params(replace(JS.R1BAD, **NARROW)))
    assert list(got) == ["pr3", "pr4", "pr5"]
    for name, a in got.items():
        want = np.asarray(JE.solve_states_long(
            "nnf", params, f"{name}-cell5",
            jnp.array([0.0, 1.0], jnp.float32)))[:, 0]
        d = np.abs(a - want)
        assert a.shape == want.shape and np.isfinite(d).all()
        assert d.max() <= GATE_MAX and np.median(d) <= GATE_MEDIAN, (
            name, d.max(), np.median(d))
    assert os.path.exists(os.path.join(outdir, "fig7.png"))
    oracle, _ = run_driver(world, "figure_7_torch", "--oracle", sub="f7o")
    for name in got:
        np.testing.assert_array_equal(oracle[name], got[name])


def test_table_s1_matches_jax_with_stored_pr4(world):
    """The two architectures under out/r1-tune (s00, s03; the others are
    skipped) and --stored-pr4's twelve stored traces."""
    got, outdir = run_driver(world, "table_s1_torch", "--stored-pr4")
    meas = jax_meas(world["ref"])
    assert list(got["rows"]) == ["s00", "s03"]
    for arch_id, row in got["rows"].items():
        spec = JS.tune_study(arch_id)
        params = JC.load_pytree(
            os.path.join(world["out"], "r1-tune", arch_id, "best-model.npz"),
            JS.init_params(replace(spec, **NARROW)))
        want = jax_measured_maes(meas, "nnf", params, JR.CELL5_R1)
        for name in ("sinewave", "aps"):
            ref_y = np.asarray(pt_load(
                f"{world['ref']}/table-s1/{arch_id}-y1-{name}.pt"),
                np.float64).reshape(-1)
            want.append(float(np.mean(np.abs(
                jax_sim("nnf", params, name, JR.CELL5_R1) - ref_y))))
        n_layers, n_nodes = JR.ARCHITECTURES[arch_id]
        assert row[0] == f"{n_layers}x{n_nodes}"
        close(row[1:], want)
    tl, i_meas = meas["pr4"]
    idx = lattice_idx(tl)
    keep = pr4_keep(idx)
    assert list(got["stored_pr4"]) == list(JR.ARCHITECTURES)
    for arch_id, (mae,) in got["stored_pr4"].items():
        y = np.asarray(pt_load(f"{world['ref']}/table-s1/{arch_id}-y1-"
                               "pr4.pt"), np.float64).reshape(-1)
        close(mae, np.mean(np.abs(y[idx[keep]]
                                   - np.asarray(i_meas)[keep])))
    for f in ("table-s1.txt", "table-s1-stored-pr4.txt"):
        assert os.path.exists(os.path.join(outdir, f))
