"""The stand-in reference checkout and shortened protocols of the s-study
parity tests (test_torch_s_studies.py, test_torch_s_runs.py).

Both packages read ``test-protocols/ap2hz.csv`` through their module global
``REFDIR``; ``standin_checkout`` points both at one stand-in that it writes
(an AP-like 300 ms waveform at 1 ms), shortens PRED_T to it, and swaps the
long protocols (the staircase, the three step families, the recorded
sinewave and APs) for 500 ms stand-ins built by each package's own
``from_time_series``: the solves still run to the studies' fixed 8-15 s
output grids, at -80 mV past the stand-in's end."""

import os

import numpy as np

from ionflux import protocols as JP
from ionflux import protorec as JRec
from ionflux import studies as JSt
from ionflux_torch import protocols as TP
from ionflux_torch import protorec as TRec
from ionflux_torch import studies as TSt

STANDIN_MS = 500


def ap2hz_rows() -> np.ndarray:
    """(t [s], v [mV]): two 60 ms AP-like excursions on -80 mV, 1 ms."""
    t = np.arange(301) * 1e-3
    v = np.full(t.shape, -80.0)
    for t0 in (0.05, 0.2):
        k = (t >= t0) & (t < t0 + 0.06)
        v[k] = -80.0 + 120.0 * np.exp(-(t[k] - t0) / 0.03)
    return np.stack([t, np.round(v, 4)], axis=-1)


def write_csv(path, rows) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, rows, delimiter=",", header="time[s],voltage[mV]",
               comments="", fmt="%.6f")


def _standin_v(level: float) -> np.ndarray:
    """A 500 ms, 1 ms-knot step to `level` at 100-300 ms, a ramp back."""
    t = np.arange(STANDIN_MS + 1, dtype=np.float64)
    v = np.full(t.shape, -80.0)
    v[(t >= 100) & (t < 300)] = level
    ramp = (t >= 300) & (t < 400)
    v[ramp] = level + (t[ramp] - 300) / 100.0 * (-80.0 - level)
    return v


def _family(levels):
    def build(pkg):
        def fam(dt_ms=0.1, device=None):
            t = np.arange(STANDIN_MS + 1, dtype=np.float64)
            if pkg is TP:
                return [TP.from_time_series(t, _standin_v(x), device="cpu")
                        for x in levels]
            return [JP.from_time_series(t, _standin_v(x)) for x in levels]
        return fam
    return build


def standin_checkout(tmp_path, monkeypatch):
    """Both packages on one stand-in reference checkout and on shortened
    protocols; returns the checkout's directory."""
    ref = str(tmp_path / "ref")
    write_csv(os.path.join(ref, "test-protocols", "ap2hz.csv"),
               ap2hz_rows())
    pred_t = np.linspace(0.0, 300.0, 151)
    t = np.arange(STANDIN_MS + 1, dtype=np.float64)
    for st in (JSt, TSt):
        monkeypatch.setattr(st, "REFDIR", ref)
        monkeypatch.setattr(st, "PRED_T", pred_t)
        monkeypatch.setattr(st, "_GT_ROLLOUTS", {})
    for name, levels in (("activation_family", (-20.0, 40.0)),
                         ("deactivation_family", (-110.0, -50.0)),
                         ("atau_family", (40.0, 10.0))):
        monkeypatch.setattr(JP, name, _family(levels)(JP))
        monkeypatch.setattr(TP, name, _family(levels)(TP))
    monkeypatch.setattr(JP, "staircase_protocol", lambda dt_ms=0.1: (
        JP.from_time_series(t, _standin_v(-20.0))))
    monkeypatch.setattr(TP, "staircase_protocol", lambda dt_ms=0.1,
                        device=None: TP.from_time_series(
                            t, _standin_v(-20.0), device="cpu"))
    rec_level = {"sinewave-cell5": 20.0, "aps-cell5": 30.0}
    monkeypatch.setattr(JRec, "protocol", lambda name, dtype=None: (
        JP.from_time_series(t, _standin_v(rec_level[name]))))
    monkeypatch.setattr(TRec, "protocol", lambda name, dtype=None,
                        device=None: TP.from_time_series(
                            t, _standin_v(rec_level[name]), device="cpu"))
    return ref
