"""The s-study pieces of ionflux_torch/studies.py against ionflux/studies.py:
prediction_cases, predict_study and s_rollout_maes, on a stand-in
reference checkout (run_study and run_study_best_of:
test_torch_s_runs.py).

Both packages run on one stand-in reference checkout and shortened
protocols (tests/_s_study_standins.py).  MAEs agree within MAE_RTOL: the two
packages' f32 solves part at round-off (tests/_torch_helpers.py), and the
MAEs here are O(0.1)."""

import os

import numpy as np
import pytest

from ionflux import studies as JSt
from ionflux.models import nn as JN
from ionflux_torch import studies as TSt
from ionflux_torch.models import nn as TN

from _s_study_standins import standin_checkout, write_csv
from _torch_helpers import assert_close, jax_net, np_, np_net, torch_net

MAE_RTOL = 2e-3


@pytest.fixture
def standin(tmp_path, monkeypatch):
    return standin_checkout(tmp_path, monkeypatch)


def _cases_equal(rows_j, rows_t) -> None:
    assert [(lab, head) for lab, head, _, _ in rows_t] == \
        [(lab, head) for lab, head, _, _ in rows_j]
    for (_, _, pj, tj), (_, _, pt, tt) in zip(rows_j, rows_t):
        for a, b in ((pj.t0, pt.t0), (pj.dt, pt.dt), (pj.v, pt.v),
                     (tj, tt)):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np_(b).astype(np.float32))


def test_prediction_cases_equal_jax(standin):
    """Labels, headers, protocols and output grids equal JAX's: with only
    ap2hz.csv in the checkout (the APs, sinewave and staircase rows fall
    back to the recordings and the parametric staircase), and with all four
    CSVs (read from the files)."""
    rows_j, rows_t = JSt.prediction_cases(), TSt.prediction_cases("cpu")
    assert len(rows_t) == 1 + 3 + 6
    assert rows_t[1][0] == "APs prediction (ap-cell-5 waveform)"
    _cases_equal(rows_j, rows_t)
    t = np.arange(0, 4.001, 0.002)
    for k, fname in enumerate(("aps.csv", "sinewave.csv", "staircase.csv")):
        v = -80.0 + 30.0 * np.sin(2 * np.pi * t * (k + 1))
        write_csv(os.path.join(standin, "test-protocols", fname),
                   np.stack([t, np.round(v, 4)], axis=-1))
    rows_j, rows_t = JSt.prediction_cases(), TSt.prediction_cases("cpu")
    assert rows_t[1][0] == "APs prediction"
    _cases_equal(rows_j, rows_t)


def test_ap2hz_pieces_name_the_missing_file(standin, monkeypatch):
    """Without ap2hz.csv both packages refuse; the port names the file and
    the variable."""
    os.remove(os.path.join(standin, "test-protocols", "ap2hz.csv"))
    with pytest.raises(OSError):
        JSt.prediction_cases()
    for refdir in (standin, None):
        monkeypatch.setattr(TSt, "REFDIR", refdir)
        with pytest.raises(FileNotFoundError,
                           match="test-protocols/ap2hz.csv.*IONFLUX_REF"):
            TSt.prediction_cases("cpu")


def _pair(seed, kind, n_nodes=16, std=0.1):
    net = np_net(seed, n_layers=1, n_nodes=n_nodes, std=std)
    if kind == "nnf":
        return (JN.NNfParams(jax_net(net), JSt.S1.rgate),
                TN.NNfParams(TN.MLP(torch_net(net)), TSt.S1.rgate))
    return (JN.NNdParams(jax_net(net), JSt.S2.base_hh),
            TN.NNdParams(TN.MLP(torch_net(net)), TSt.S2.base_hh))


def test_s_rollout_maes_match_jax(standin):
    """s_rollout_maes on an S1 (NN-f) net: every entry within MAE_RTOL of
    JAX's, the ground truth cached once; a NaN net scores inf everywhere in
    both."""
    pj, pt = _pair(3, "nnf")
    want = JSt.s_rollout_maes(JSt.S1, pj)
    got = TSt.s_rollout_maes(TSt.S1, pt)
    keys = ["ap2hz", "sin", "stair", "act", "deact", "score"]
    assert list(got) == list(want) == keys
    assert all(np.isfinite(got[k]) and got[k] > 1e-3 for k in keys)
    assert_close([got[k] for k in keys], [want[k] for k in keys], atol=0.0,
                 rtol=MAE_RTOL)
    assert len(TSt._GT_ROLLOUTS) == len(JSt._GT_ROLLOUTS) == 3 + 2 + 2
    bad = TN.NNfParams(TN.MLP([(w * np.nan, b) for w, b in pt.net.layers]),
                       TSt.S1.rgate)
    bad_j = JN.NNfParams([(w * np.nan, b) for w, b in pj.net], JSt.S1.rgate)
    assert TSt.s_rollout_maes(TSt.S1, bad) == JSt.s_rollout_maes(
        JSt.S1, bad_j) == {k: float("inf") for k in keys}


def test_predict_study_matches_jax(standin, capsys):
    """predict_study on an S2 (NN-d) net: the same rows, printed under the
    same headers, the MAEs within MAE_RTOL."""
    pj, pt = _pair(5, "nnd", std=0.3)
    want = JSt.predict_study(JSt.S2, pj)
    out_j = capsys.readouterr().out
    got = TSt.predict_study(TSt.S2, pt)
    out_t = capsys.readouterr().out
    assert list(got) == list(want)
    assert_close(list(got.values()), list(want.values()), atol=0.0,
                 rtol=MAE_RTOL)
    strip = [ln.split("|")[0] for ln in out_j.splitlines()]
    assert [ln.split("|")[0] for ln in out_t.splitlines()] == strip
    assert "Activation prediction:" in strip


