"""The port's r-study data (ionflux_torch/rstudies.py, the registry's
cell-5 entries) against the JAX package's: the registry entries bit for
bit, ``init_params``' layout, ``load_reference_surface`` on a cache without
t.pt, and ``surface_from_recordings`` on short stand-in CSVs written into
tmp_path (the data-present path; both packages on the short protocols of
``_r_study_standins``)."""

import os

import numpy as np
import pytest

import _r_study_standins as RS
from ionflux import protorec as JRec
from ionflux import rstudies as JS
from ionflux_torch import protorec as TRec
from ionflux_torch import rstudies as TS

from _torch_helpers import np_
from test_torch_rstudies import refdir  # noqa: F401  (the stand-in fixture)


@pytest.mark.parametrize("name", [
    "CELL5_RGATE", "HH_CELL5_INIT", "HH_CELL5_FIT", "R1BAD_RGATE",
    "HH_R1BAD_INIT", "HH_R0BAD_FIT", "ARCHITECTURES", "CELL5_RAW",
    "CELL5_R1", "CELL5_R2", "CELL5_R1BAD"])
def test_registry_cell5_entries_equal(name):
    """The registry's cell-5 entries bit for bit (values and types)."""
    from ionflux.models import registry as JReg
    from ionflux_torch.models import registry as TReg

    t, j = getattr(TReg, name), getattr(JReg, name)
    if isinstance(j, dict):
        assert t == j
        return
    assert type(t).__name__ == type(j).__name__
    assert [type(x) for x in t] == [type(x) for x in j]
    assert [np.asarray(x).tobytes() for x in t] == \
        [np.asarray(x).tobytes() for x in j]


@pytest.mark.parametrize("name", ["R1", "R2", "R1BAD"])
def test_init_params_layout_equal(name):
    """init_params: the same layer shapes and HH scalars (the draws differ:
    jax.random is not reproduced), weights on the spec's scale."""
    st, sj = getattr(TS, name), getattr(JS, name)
    pt, pj = TS.init_params(st, device="cpu"), JS.init_params(sj)
    assert [tuple(w.shape) for w, _ in pt.net.layers] == \
        [tuple(np.shape(w)) for w, _ in pj.net]
    assert [float(x) for x in pt[1]] == [float(x) for x in pj[1]]
    w0 = np_(pt.net.layers[1][0])
    assert abs(float(w0.std()) / st.init_std - 1.0) < 0.05


def test_load_reference_surface_without_t(refdir):
    """r1-bad's cache has no t.pt: t is 0, 1, 2, ... in both."""
    got = TS.load_reference_surface(TS.R1BAD)
    want = JS.load_reference_surface(JS.R1BAD)
    assert np.array_equal(got[0], np.arange(got[1].size))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def _write_recordings(d, names, seed=0):
    """Short stand-in cell-5 CSVs (time ms, current nA, voltage mV): the
    cell-5 HH fit's current on the short protocols plus numpy noise."""
    from ionflux_torch.models import registry as TReg

    rs = np.random.RandomState(seed)
    files = {"pr3": "pr3-steady-activation-cell-5.csv",
             "pr4": "pr4-inactivation-cell-5.csv",
             "pr5": "pr5-deactivation-cell-5.csv"}
    for name in names:
        v, dt = RS.short_voltage(f"{name}-cell5")
        a = RS.gate_trace(v, dt, TReg.HH_CELL5_FIT[:4], 0.0)
        r = RS.gate_trace(v, dt, TReg.CELL5_RGATE, 1.0, rgate=True)
        c = TReg.CELL5_R1
        i = float(c.g) * a * r * (v - float(c.e))
        i = i + 0.005 * rs.randn(v.size)
        t = np.arange(v.size) * dt
        np.savetxt(os.path.join(d, files[name]), np.stack([t, i, v], 1),
                   delimiter=",", header="t,i,v", comments="")


@pytest.mark.parametrize("name, smoothi", [("R1", False), ("R1", True),
                                           ("R1BAD", False)])
def test_surface_from_recordings_matches_jax(monkeypatch, tmp_path, name,
                                             smoothi):
    """The data-present path on short stand-in CSVs in tmp_path: the same
    retained samples.  The short protocols step every 50-200 ms, so the two
    f32 r-gate solves' differences just past an edge (up to 9e-5 in r,
    test_torch_realdata.py) reach the retained samples before they decay,
    and da/dt divides by r: a within 5e-4 (1e-3 with the exp fits, which
    stop at scipy's 1e-4 tolerances) and da/dt within 1e-2 of their ranges
    at most (1.6e-4, 6.8e-4 and 4.9e-3 measured), and on the spline path
    99% of the samples within 1e-4 of the range."""
    RS.patch_short(monkeypatch, TRec, JRec)
    _write_recordings(str(tmp_path), ["pr3", "pr4", "pr5"])
    got = TS.surface_from_recordings(getattr(TS, name), str(tmp_path),
                                     smoothi=smoothi, device="cpu")
    want = JS.surface_from_recordings(getattr(JS, name), str(tmp_path),
                                      smoothi=smoothi)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    for a, b, tol in zip(got[2:], want[2:],
                         (1e-3 if smoothi else 5e-4, 1e-2)):
        assert a.size > 100 and np.all(np.isfinite(a))
        err = np.abs(a - b) / np.ptp(b)
        assert np.max(err) <= tol
        assert smoothi or np.percentile(err, 99) <= 1e-4
