"""The port's real-data pipeline (ionflux_torch/realdata.py) against the JAX
package's (ionflux/realdata.py): both derivative-surface variants on
tests/test_realdata.py's stand-in recording, and the cache half
(``_cache_lattice``, ``recover_measurements``, ``smoothi_refit_cache``) on
short stand-in surface caches written by ``_r_study_standins``, which both
packages read (the port with ``torch.load``, JAX with its own reader)."""

import numpy as np
import pytest
import torch

import _r_study_standins as RS
from ionflux import protorec as JRec
from ionflux import realdata as JR
from ionflux.models.registry import HH_B06 as J_HH_B06
from ionflux.models.registry import SYNTHETIC as J_SYN
from ionflux_torch import protorec as TRec
from ionflux_torch import realdata as TR
from ionflux_torch.models import registry as TReg
from test_realdata import _standin_recording


@pytest.fixture(scope="module")
def recording():
    return _standin_recording()


def test_constants_and_config_equal():
    assert TR.PR5_BI_TIMES == JR.PR5_BI_TIMES
    assert TR.PR5_CMA_VOLTAGES == JR.PR5_CMA_VOLTAGES
    assert TR.RealSurfaceConfig().__dict__ == JR.RealSurfaceConfig().__dict__


def test_load_recording_and_known_r(recording, tmp_path):
    """The CSV reader bit for bit; the known r-gate by each package's f32
    adaptive solve: their step sequences part at round-off, so the dense
    outputs differ most beside a step edge (9.3e-5 at the 7,500 ms edge):
    2e-4, and dr/dt within 2e-4 of its range."""
    t, i, v, _ = recording
    path = tmp_path / "rec.csv"
    np.savetxt(path, np.stack([t, i, v], axis=1)[:2000], delimiter=",",
               header="t,i,v", comments="")
    for a, b in zip(TR.load_recording(str(path)),
                    JR.load_recording(str(path))):
        assert np.array_equal(a, b)
    r_t, dr_t = TR._known_r(t, v, TReg.HH_B06, device="cpu")
    r_j, dr_j = JR._known_r(t, v, J_HH_B06)
    assert r_t.dtype == np.float64
    assert np.max(np.abs(r_t - r_j)) <= 2e-4
    assert np.max(np.abs(dr_t - dr_j)) <= 2e-4 * np.ptp(dr_j)


def test_real_surface_spline_matches_jax(recording):
    """Same splines on the host; the r-gates differ as above: a within 5e-5
    and da/dt within 5e-4 of their ranges (1.3e-5 and 1.8e-4 measured)."""
    t, i, v, _ = recording
    got = TR.real_surface_spline(t, i, v, TReg.HH_B06, TReg.SYNTHETIC,
                                 device="cpu")
    want = JR.real_surface_spline(t, i, v, J_HH_B06, J_SYN)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    for a, b, tol in zip(got[2:], want[2:], (5e-5, 5e-4)):
        assert np.max(np.abs(a - b)) <= tol * np.ptp(b)


def test_real_surface_smoothi_matches_jax(recording):
    """The exp-fit variant, with a sinewave window (sine_times) and a
    bi-exp window, from the same initial guesses: the Nelder-Mead fits stop
    at scipy's 1e-4 tolerances from inputs that differ at the r-gate's
    round-off, so within 1e-3 of each column's range."""
    t, i, v, _ = recording
    kw = dict(bi_exp_times=(7200.0,), sine_times=(500.0,))
    cfg_t = TR.RealSurfaceConfig(std_cutoff=0.01)
    cfg_j = JR.RealSurfaceConfig(std_cutoff=0.01)
    got = TR.real_surface_smoothi(t, i, v, TReg.HH_B06, TReg.SYNTHETIC,
                                  cfg_t, **kw, device="cpu")
    want = JR.real_surface_smoothi(t, i, v, J_HH_B06, J_SYN, cfg_j, **kw)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    for a, b in zip(got[2:], want[2:]):
        assert np.all(np.isfinite(a))
        assert np.max(np.abs(a - b)) <= 1e-3 * np.ptp(b)


@pytest.fixture
def caches(monkeypatch, tmp_path):
    """The short stand-in r1/ and r1-bad/ caches, both packages' protorec
    on the short protocols."""
    RS.patch_short(monkeypatch, TRec, JRec)
    counts = RS.write_r_caches(str(tmp_path))
    assert counts == {"r1": 2704, "r1-bad": 2648}
    return str(tmp_path)


@pytest.mark.parametrize("sub, protocols, n_points", [
    ("r1", ("pr3", "pr5"), 70), ("r1-bad", ("pr3", "pr4"), 30)])
def test_cache_lattice_both_branches(caches, sub, protocols, n_points):
    d = f"{caches}/{sub}"
    v = torch.load(f"{d}/v.pt").numpy()
    st_t, sm_t = TR._cache_lattice(d, protocols, v, n_points)
    st_j, sm_j = JR._cache_lattice(d, protocols, v, n_points)
    for name in protocols:
        assert np.array_equal(st_t[name], st_j[name])
        assert np.array_equal(sm_t[name], sm_j[name])
    if sub == "r1":
        with pytest.raises(ValueError, match="hardcoded"):
            TR._cache_lattice(d, ("pr3", "pr4"), v, n_points)


def test_cache_lattice_asserts_on_a_corrupted_v(caches):
    """r1-bad's lattice is rebuilt from the protocol masks, so a cached v
    that is not the protocol's samples fails the assert in both."""
    d = f"{caches}/r1-bad"
    v = torch.load(f"{d}/v.pt").numpy().copy()
    v[5] += 1.0
    for pkg in (TR, JR):
        with pytest.raises(AssertionError):
            pkg._cache_lattice(d, ("pr3", "pr4"), v, 30)


RECOVERY_CASES = [
    ("r1", dict(c="CELL5_R1", rgate="HH_CELL5_INIT")),
    ("r1-bad", dict(c="CELL5_R1BAD", rgate="HH_R1BAD_INIT",
                    protocols=("pr3", "pr4"), n_points=30))]


def _recovery_args(args):
    from ionflux.models import registry as JReg

    kw = {k: v for k, v in args.items() if k not in ("c", "rgate")}
    return (kw, getattr(TReg, args["c"]), getattr(TReg, args["rgate"]),
            getattr(JReg, args["c"]), getattr(JReg, args["rgate"]))


@pytest.mark.parametrize("sub, args", RECOVERY_CASES)
def test_recover_measurements_matches_jax(caches, sub, args):
    """float64 on both sides (stated: the defaults follow torch's default
    dtype and JAX's x64 flag).  The same lattice; the port's currents
    within 1e-5 of their range (5.4e-7 measured: its per-sweep solve stops
    at each 0.1 ms step ramp) of a g r (V - E) with r by the exact
    propagator; JAX's within 1e-4 of the port's: its adaptive r-gate
    crosses the ramps less closely (just after the short Pr3's 50 ms edge
    it is 4.8e-3 off the exact r), and some ms later, on the lattice, up
    to 1.2e-5 of the range is left.  In float32 (the port's default here)
    within 1e-4 of the float64 currents' range."""
    import jax.numpy as jnp

    d = f"{caches}/{sub}"
    kw, c, rgate, c_j, rgate_j = _recovery_args(args)
    got = TR.recover_measurements(d, c, rgate, dtype=torch.float64,
                                  device="cpu", **kw)
    want = JR.recover_measurements(d, c_j, rgate_j, dtype=jnp.float64, **kw)
    assert list(got) == list(want)
    errs = RS.recovery_errors(d, got, c, rgate)
    for name in got:
        assert np.array_equal(got[name][0], want[name][0])
        i_t, i_j = got[name][1], want[name][1]
        assert i_t.dtype == np.float64
        rng = np.ptp(i_t)
        assert np.max(errs[name][1]) <= 1e-5
        assert np.max(np.abs(i_j - i_t)) <= 1e-4 * rng
    f32 = TR.recover_measurements(d, c, rgate, device="cpu", **kw)
    for name in got:
        assert f32[name][1].dtype == np.float64      # a (f64) x r (f32)
        np.testing.assert_allclose(f32[name][1], got[name][1],
                                   atol=1e-4 * np.ptp(got[name][1]))


@pytest.mark.parametrize("sub, args", RECOVERY_CASES)
def test_recover_measurements_float32_matches_jax(caches, sub, args):
    """float32 on both sides, each package's default without x64 (JAX's
    called with x64 turned off).  On these two-sweep stand-ins one f32
    clock keeps its resolution, so JAX's one-clock solve and the port's
    per-sweep chain differ only as each crosses the step ramps: within
    2e-4 of the current's range (1.1e-4 measured, on Pr4); against a g r
    (V - E) with r by the exact propagator, the port's within 1e-5 (2.0e-6
    measured) and JAX's within 2e-4 (1.1e-4).  (At full length one f32
    clock parts further: PERF.md.)"""
    import jax

    d = f"{caches}/{sub}"
    kw, c, rgate, c_j, rgate_j = _recovery_args(args)
    got = TR.recover_measurements(d, c, rgate, dtype=torch.float32,
                                  device="cpu", **kw)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        want = JR.recover_measurements(d, c_j, rgate_j, **kw)
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert list(got) == list(want)
    errs_t = RS.recovery_errors(d, got, c, rgate)
    errs_j = RS.recovery_errors(d, want, c, rgate)
    for name in got:
        assert np.array_equal(got[name][0], want[name][0])
        i_t, i_j = got[name][1], np.asarray(want[name][1], np.float64)
        assert np.max(np.abs(i_j - i_t)) <= 2e-4 * np.ptp(i_t)
        assert np.max(errs_t[name][1]) <= 1e-5
        assert np.max(errs_j[name][1]) <= 2e-4


def test_smoothi_refit_cache_matches_jax(caches):
    """The cache refit (fit_exp_ls and splines on the same cached arrays):
    bit for bit, on the first three segments of each protocol."""
    d = f"{caches}/r1"
    got = TR.smoothi_refit_cache(d, max_segments=3)
    want = JR.smoothi_refit_cache(d, max_segments=3)
    assert list(got) == list(want) == ["pr3", "pr5"]
    for name in got:
        assert set(got[name]) == set(want[name])
        assert {"tri", "spline"} & set(got[name]["branch"])
        for k in got[name]:
            assert np.array_equal(got[name][k], want[name][k]), (name, k)
