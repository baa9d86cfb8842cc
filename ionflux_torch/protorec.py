"""The recorded cell-5 voltage-clamp protocols (counterpart of the asset and
closed-form half of ``ionflux/protorec.py``).

Pr3, Pr4, Pr5 and the sinewave protocol have a closed form and are built by
numpy from the constants below; the action-potential waveform exists only as
a stored asset.  The assets are the JAX package's ``*.npz`` files, read in
place.  The tooling that reconstructed them from the reference's simulation
artifacts is not part of this module.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ionflux_torch import protocols as P

DT_MS = 0.1  # all cell-5 recordings are sampled at 0.1 ms

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "ionflux", "assets", "protocols")


def _steps(n: int, segments: list[tuple[int, float]]) -> np.ndarray:
    """Per-sample voltage from (first_sample_index, level) pairs."""
    v = np.empty(n, np.float64)
    starts = [s for s, _ in segments] + [n]
    for (s, lvl), e in zip(segments, starts[1:]):
        v[s:e] = lvl
    return v


def sinewave_cell5_voltage() -> np.ndarray:
    """The sinewave protocol (80,000 samples, 8 s): a step scaffold with the
    published Beattie-2018 3-sine waveform in the window (3000, 6500] ms,
    referenced to t0 = 2500 ms."""
    n = 80000
    t = np.arange(n) * DT_MS
    v = _steps(n, [
        (0, -80.0),        # hold
        (2501, -120.0),    # 50 ms leak step
        (3001, -80.0),
        (5001, 40.0),      # 1 s activation
        (15001, -120.0),   # 0.5 s
        (20001, -80.0),
        (30001, 0.0),      # sine window, filled below
        (65001, -120.0),
        (70001, -80.0),
    ])
    w = np.s_[30001:65001]
    x = t[w] - 2500.0
    v[w] = (-30.0 + 54.0 * np.sin(0.007 * x) + 26.0 * np.sin(0.037 * x)
            + 10.0 * np.sin(0.19 * x))
    return v


# Pr3 (steady activation, 7 sweeps).  Sweep-local layout after the leak
# step, in samples (0.1 ms):
#   -120 x 500 | -80 x 2000 | test x 50000 | -40 x 10000 | -120 x 5000 |
#   -80 until the next sweep.  First leak sample 3791, period 82580 samples,
#   total 578060 samples.
PR3_TEST_V = (-60.0, -40.0, -20.0, 0.0, 20.0, 40.0, 60.0)
PR3_N = 578060
PR3_LEAK0 = 3791
PR3_PERIOD = 82580


def pr3_cell5_voltage() -> np.ndarray:
    segs: list[tuple[int, float]] = [(0, -80.0)]
    for k, tv in enumerate(PR3_TEST_V):
        s = PR3_LEAK0 + k * PR3_PERIOD
        segs += [(s, -120.0), (s + 500, -80.0), (s + 2500, tv),
                 (s + 52500, -40.0), (s + 62500, -120.0), (s + 67500, -80.0)]
    return _steps(PR3_N, segs)


# Pr5 (deactivation, 9 sweeps).  Sweep-local layout:
#   -120 x 500 | -80 x 2000 | +50 x 20000 | test x 60000 | -120 x 5000 |
#   -80 until the next sweep.  First leak sample 4112, period 103224
#   samples, total 9 full periods.
PR5_TEST_V = (-120.0, -110.0, -100.0, -90.0, -80.0, -70.0, -60.0, -50.0,
              -40.0)
PR5_N = 9 * 103224
PR5_LEAK0 = 4112
PR5_PERIOD = 103224


def pr5_cell5_voltage() -> np.ndarray:
    segs: list[tuple[int, float]] = [(0, -80.0)]
    for k, tv in enumerate(PR5_TEST_V):
        s = PR5_LEAK0 + k * PR5_PERIOD
        segs += [(s, -120.0), (s + 500, -80.0), (s + 2500, 50.0),
                 (s + 22500, tv), (s + 82500, -120.0), (s + 87500, -80.0)]
    return _steps(PR5_N, segs)


# Pr4 (inactivation, 16 sweeps).  Sweep-local layout: -80 | -120 x 500
# (leak) | -80 x 2000 | +50 x 6000 | -90 x 600 | test x 1500 | -120 x 5000 |
# -80 until the next sweep.  First leak sample 2954, period 29006 samples,
# total 464096 samples.
PR4_TEST_V = tuple(float(x) for x in range(-100, 60, 10))
PR4_N = 464096
PR4_LEAK0 = 2954
PR4_PERIOD = 29006


def pr4_cell5_voltage() -> np.ndarray:
    segs: list[tuple[int, float]] = [(0, -80.0)]
    for k, tv in enumerate(PR4_TEST_V):
        s = PR4_LEAK0 + k * PR4_PERIOD
        segs += [(s, -120.0), (s + 500, -80.0), (s + 2500, 50.0),
                 (s + 8500, -90.0), (s + 9100, tv), (s + 10600, -120.0),
                 (s + 15600, -80.0)]
    return _steps(PR4_N, segs)


# Sweep structure of the multi-sweep recordings: (n_sweeps, samples/sweep).
SWEEPS = {
    "pr3-cell5": (7, PR3_PERIOD),
    "pr4-cell5": (16, PR4_PERIOD),
    "pr5-cell5": (9, PR5_PERIOD),
}

_ANALYTIC = {
    "pr3-cell5": pr3_cell5_voltage,
    "pr4-cell5": pr4_cell5_voltage,
    "pr5-cell5": pr5_cell5_voltage,
    "sinewave-cell5": sinewave_cell5_voltage,
}


def load_voltage(name: str) -> tuple[np.ndarray, float]:
    """Per-sample (voltage, dt).  Prefers the stored asset (exact recovered
    samples, e.g. the APs waveform); falls back to the closed form for
    protocols with a closed form."""
    path = os.path.join(ASSET_DIR, f"{name}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["v"].astype(np.float64), float(z["dt"])
    if name in _ANALYTIC:
        return _ANALYTIC[name](), DT_MS
    raise FileNotFoundError(f"no protocol asset '{name}' in {ASSET_DIR}")


def protocol(name: str, dtype=torch.float32, device=None) -> P.Protocol:
    """A recorded protocol as a Protocol (linear interpolation at 0.1 ms),
    on the card unless ``device`` says otherwise."""
    v, dt = load_voltage(name)
    t = np.arange(len(v)) * dt
    return P.from_time_series(t, v, dtype=dtype, device=device)


def available() -> list[str]:
    names = set(_ANALYTIC)
    if os.path.isdir(ASSET_DIR):
        names |= {f[:-4] for f in os.listdir(ASSET_DIR) if f.endswith(".npz")}
    return sorted(names)
