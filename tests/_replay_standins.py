"""Stand-in recordings and pre-seeded trace caches for the replay drivers'
tests (test_torch_figures.py, test_torch_replay_drivers.py).

The recordings are short (1 ms samples; two sweeps of Pr3 and Pr5, Pr4's
16) but long enough for figures 2 and 3's zoom windows (to 9,100 ms).  The
caches hold smooth made-up currents under the drivers' own names, so a
``--cached`` run simulates nothing."""

import os

import numpy as np

SWEEPS = {"pr3-cell5": (2, 7200), "pr4-cell5": (16, 200),
          "pr5-cell5": (2, 9200)}
SINGLE = {"sinewave-cell5": 7100, "aps-cell5": 6600}
NAMES = list(SWEEPS) + list(SINGLE)
COLS = {"pr3-cell5": "Pr3", "pr5-cell5": "Pr5", "pr4-cell5": "Pr4",
        "sinewave-cell5": "Sinusoidal", "aps-cell5": "APs"}
LABELS = ("Original", "NN-f", "NN-d")


def voltage(name):
    """(v [mV], dt = 1 ms): steps to +20 mV and back, or a sinusoid."""
    if name in SWEEPS:
        n_sw, period = SWEEPS[name]
        sweep = np.full(period, -80.0)
        sweep[period // 8: period // 2] = 20.0
        sweep[period // 2: 5 * period // 8] = -110.0
        return np.tile(sweep, n_sw), 1.0
    t = np.arange(SINGLE[name], dtype=np.float64)
    return np.round(-80.0 + 60.0 * np.sin(2 * np.pi * t / 700.0), 3), 1.0


def patch(monkeypatch, *recs) -> None:
    """Point each protorec module (JAX's, the port's) at the stand-ins."""
    for rec in recs:
        monkeypatch.setattr(rec, "load_voltage", voltage)
        monkeypatch.setattr(rec, "SWEEPS", SWEEPS)


def trace(name: str, k: int) -> np.ndarray:
    """A smooth made-up current on a stand-in recording; k = 0 the truth,
    k > 0 the k-th model (off by a scale and a drift)."""
    v, _ = voltage(name)
    t = np.arange(v.size, dtype=np.float64)
    base = 0.05 * (v + 88.4) * (1 - np.exp(-(t % 700) / 90.0))
    return base * (1 + 0.03 * k) + 0.01 * k * np.sin(t / 311.0)


def write(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **arrays)


def seed_table_1(out: str) -> None:
    """The table-1 drivers' caches: <col>-gt and <col>-table-1.txt-<label>."""
    for name, col in COLS.items():
        write(os.path.join(out, f"{col}-gt.npz"), y=trace(name, 0))
        for k, label in enumerate(LABELS, 1):
            write(os.path.join(out, f"{col}-table-1.txt-{label}.npz"),
                  y=trace(name, k))


def seed_figure(out: str, names, s: bool = False) -> None:
    """Figures 2 and 3's caches: <name>-gt[-s] and <name>-<label>."""
    for name in names:
        write(os.path.join(out, f"{name}-gt{'-s' if s else ''}.npz"),
              y=trace(name, 0))
        for k, label in enumerate(LABELS, 1):
            write(os.path.join(out, f"{name}-{label}.npz"), y=trace(name, k))


def seed_portraits(out: str, names) -> None:
    """Figure 1's trajectories: <name>-hh and <name>-gta, (a, da/dt)."""
    for name in names:
        v, _ = voltage(name)
        t = np.arange(v.size, dtype=np.float64)
        for kind, lag in (("hh", 40.0), ("gta", 60.0)):
            a = 0.5 + 0.4 * np.tanh((v + 40.0) / 20.0) * (
                1 - np.exp(-(t % 700) / lag))
            write(os.path.join(out, f"{name}-{kind}.npz"), a=a,
                  z=np.gradient(a))
