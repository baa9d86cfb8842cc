"""The stand-ins and the JAX compositions shared by the r-study replay
parity tests (test_torch_r_replay.py, test_torch_r_replay_figures.py).

The stand-ins: the short cell-5 protocols and r1/, r1-bad/ caches of
``_r_study_standins``, the reference's .pt files of ``_r_replay_standins``
(state dicts, stored traces) and an ap2hz.csv of ``_s_study_standins``
under one checkout that the port reads through ``studies.REFDIR``; and,
as the drivers' out/, narrowed nets (5 x 8, numpy-seeded) saved in the
shared npz layout, the drivers' ROOT pointed at them.  The JAX drivers
read the reference checkout's fixed path when imported, so none can be
imported on a stand-in: ``jax_meas`` and ``jax_sim`` are the JAX helpers they call, in
their order.

Tolerances: MAEs 2e-3 relative (tests/test_torch_rstudies.py's: two f32
adaptive solves, the measurement recovered per sweep in the port and on
one clock in JAX, which agree within 2e-4 of the range on these
stand-ins); gate trajectories 2.5e-3 anywhere and 1e-5 at the median
(tests/test_torch_long.py's)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import _r_replay_standins as RR
import _r_study_standins as RS
import _s_study_standins as SS
import ionflux.realdata as JRD
from ionflux import eval as JE
from ionflux import protorec as JRec
from ionflux.models import registry as JR
from ionflux.observe import gate_current as j_gate_current
from ionflux_torch import protorec as TRec
from ionflux_torch import rstudies as TS
from ionflux_torch import studies as TSt
from ionflux_torch.utils import ckpt as TC

from _torch_helpers import np_net, torch_net

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
MAE_RTOL = 2e-3
GATE_MAX, GATE_MEDIAN = 2.5e-3, 1e-5
NARROW = dict(n_layers=5, n_nodes=8)
DRIVERS = ("table_2_torch", "table_s1_torch", "figure_4_torch",
           "figure_4_s_torch", "figure_5_torch", "figure_6_torch",
           "figure_7_torch", "figure_supplements_torch")
# the narrowed models the drivers read: out/<dir>/<file> <- (spec, seed)
MODELS = {
    "r1/best-model.npz": (TS.R1, 1), "r2/best-model.npz": (TS.R2, 2),
    "r1-bad/model.npz": (TS.R1BAD, 3), "s1/model.npz": (TSt.S1, 4),
    "s2/model.npz": (TSt.S2, 5), "d1/model.npz": (TSt.D1, 8),
    "d2/model.npz": (TSt.D2, 9),
    "r1-tune/s00/best-model.npz": (TS.tune_study("s00"), 6),
    "r1-tune/s03/best-model.npz": (TS.tune_study("s03"), 7),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The stand-in checkout and out/, both packages' protocols shortened,
    the port's REFDIR and the drivers' ROOT pointed at them."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("r_replay")
    RS.patch_short(mp, TRec, JRec)
    for rec in (TRec, JRec):   # Pr4's sweeps 1-3 (PR4_N // 16 a sweep):
        mp.setattr(rec, "PR4_N", 16 * RS.SHORT["pr4-cell5"][1])  # sweep 1
    ref, root = str(tmp / "ref"), str(tmp / "root")
    out = os.path.join(root, "out")
    for rel, (spec, seed) in MODELS.items():
        std = 1e-3 if spec.model_kind == "nnd" else 0.05
        net = torch_net(np_net(seed, std=std, **NARROW))
        wrap = TS.wrap_net if hasattr(spec, "surface_dir") else TSt.wrap_net
        os.makedirs(os.path.dirname(os.path.join(out, rel)), exist_ok=True)
        TC.save_pytree(os.path.join(out, rel), wrap(spec, net))
    RS.write_r_caches(ref)
    RR.write_replay_files(ref, out)
    SS.write_csv(os.path.join(ref, "test-protocols", "ap2hz.csv"),
                 SS.ap2hz_rows())
    mp.setattr(TSt, "REFDIR", ref)
    mp.syspath_prepend(SCRIPTS)
    for name in DRIVERS:
        mod = __import__(name)
        if hasattr(mod, "ROOT"):
            mp.setattr(mod, "ROOT", root)
    # zoom windows inside the stand-ins' 480-540 ms sweeps and 300 ms traces
    z = [(50.0, 140.0, -1.0, 1.0, "C0"), (160.0, 280.0, -1.0, 1.0, "C1")]
    for name in ("figure_4_torch", "figure_5_torch", "figure_6_torch"):
        mp.setattr(sys.modules[name], "zooms", lambda: {
            n: z for n in ("pr3", "pr4", "pr5", "sinewave", "aps")})
    mp.setattr(sys.modules["figure_4_s_torch"], "ZOOM",
               ((100, 250), (-1.0, 1.0), (-2.0, 2.0)))
    yield {"ref": ref, "root": root, "out": out, "tmp": tmp}
    mp.undo()


def run_driver(world, driver: str, *flags, sub: str | None = None):
    outdir = os.path.join(world["tmp"], sub or driver)
    got = sys.modules[driver].main(["--device", "cpu", "--outdir", outdir,
                                    *flags])
    return got, outdir


def jax_meas(ref: str) -> dict:
    f32 = jnp.float32
    m35 = JRD.recover_measurements(f"{ref}/r1", JR.CELL5_R1,
                                   JR.HH_CELL5_INIT, dtype=f32)
    m4 = JRD.recover_measurements(f"{ref}/r1-bad", JR.CELL5_R1BAD,
                                  JR.HH_R1BAD_INIT, protocols=("pr3", "pr4"),
                                  n_points=30, dtype=f32)
    return {"pr3": m35["pr3"], "pr5": m35["pr5"], "pr4": m4["pr4"]}


def jax_sim(kind, params, name, c) -> np.ndarray:
    rec = f"{name}-cell5"
    if rec in JRec.SWEEPS:
        return np.asarray(JE.simulate_long(kind, params, rec, c), np.float64)
    v, _ = JRec.load_voltage(rec)
    return np.asarray(j_gate_current(JE.solve_states_real(kind, params, rec),
                                     jnp.asarray(v, jnp.float32), c),
                      np.float64)


def lattice_idx(tl):
    return np.round(np.asarray(tl) / JRec.DT_MS).astype(np.int64)


def pr4_keep(idx):
    n = JRec.PR4_N // 16
    return (idx >= n) & (idx < 4 * n)


def jax_measured_maes(meas, kind, params, c) -> list:
    vals = []
    for name in ("pr3", "pr5", "pr4"):
        tl, i_meas = meas[name]
        idx, i_meas = lattice_idx(tl), np.asarray(i_meas)
        i = jax_sim(kind, params, name, c)
        if name == "pr4":
            keep = pr4_keep(idx)
            idx, i_meas = idx[keep], i_meas[keep]
        vals.append(float(np.mean(np.abs(i[idx] - i_meas))))
    return vals


def close(got, want, rel=MAE_RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel)
