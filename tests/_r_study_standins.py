"""Stand-in r-study surface caches: ``r1/`` (Pr3 + Pr5, 7 ms mask) and
``r1-bad/`` (Pr3 + Pr4, 3 ms mask) in the reference's layout, written with
``torch.save`` from the recorded cell-5 protocols (``ionflux_torch.
protorec``; tests shorten them by patching ``load_voltage`` and ``SWEEPS``).

Importable without JAX: ``chip_smoke.py`` writes the full-length caches
with it, the parity tests short ones.  Everything is numpy float64 and
deterministic, so both packages read the same files on any machine.

- ``r1/``: ``t.pt`` (Pr3's retained times, then Pr5's after
  ``(len(Pr3) - 1) * dt`` on one clock), ``v.pt``, ``a.pt``, ``dadt.pt``,
  ``d2adt2.pt`` on the lattice ``training_mask(v, 70)[10::7]``.  ``a`` is
  HH_CELL5_FIT's a-gate (from a = 0 at each protocol's start) plus seed-0
  ``RandomState`` noise of ``R1_NOISE``; ``dadt`` and ``d2adt2`` are the
  clean gate's.
- ``r1-bad/``: the same without ``t.pt`` on ``training_mask(v, 30)[10::7]``.
  ``a = a_true (V + 86) / (V - E)`` with ``a_true`` the a-gate of
  ``R1BAD_TRUTH`` carried across Pr3 into Pr4 from a = 0, and E
  CELL5_R1BAD's, so the measured current ``recover_measurements`` gives
  back is ``0.1524 a_true r (V + 86)``: the r0-bad model of R1BAD_TRUTH.

``gate_trace`` is the exact propagator of one HH gate on a per-sample
protocol (closed-form exponentials on constant samples, 32 frozen-voltage
substeps across each 0.1 ms ramp between two levels); it also gives the
r-gate that ``chip_smoke.py`` holds ``recover_measurements`` against.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch import protorec
from ionflux_torch.models.registry import (CELL5_R1BAD, HH_CELL5_FIT,
                                           HH_R0BAD_FIT)

R1_NOISE = 1e-3
# the r1-bad stand-in's generating a-gate: the reference r0-bad fit's p1-p4
R1BAD_TRUTH = np.array([float(x) for x in HH_R0BAD_FIT[:4]])
R1BAD_E = -86.0   # the r0-bad model's driving force, g a r (V + 86)
RAMP_SUB = 32


def gate_trace(v: np.ndarray, dt: float, p, y0: float,
               rgate: bool = False) -> np.ndarray:
    """One gate on a per-sample protocol v (linear between samples), at
    every sample, float64.  a-gate: k_on = p1 e^{p2 V}, k_off = p3
    e^{-p4 V}; r-gate (rgate=True, p = p5-p8): k_on = p7 e^{-p8 V},
    k_off = p5 e^{p6 V}."""
    v = np.asarray(v, np.float64)
    p = [float(x) for x in p]

    def rates(vv):
        if rgate:
            return p[2] * np.exp(-p[3] * vv), p[0] * np.exp(p[1] * vv)
        return p[0] * np.exp(p[1] * vv), p[2] * np.exp(-p[3] * vv)

    out = np.empty(v.shape)
    out[0] = y = float(y0)
    change = np.flatnonzero(v[1:] != v[:-1]) + 1   # first sample of a level
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [v.size]])
    for s, e in zip(starts, ends):
        if s > 0:   # the ramp from sample s - 1 to s
            h = dt / RAMP_SUB
            for j in range(RAMP_SUB):
                vm = v[s - 1] + (j + 0.5) / RAMP_SUB * (v[s] - v[s - 1])
                kon, koff = rates(vm)
                lam = kon + koff
                y = kon / lam + (y - kon / lam) * np.exp(-lam * h)
            out[s] = y
        kon, koff = rates(v[s])
        lam = kon + koff
        k = np.arange(e - s)
        out[s:e] = kon / lam + (y - kon / lam) * np.exp(-lam * k * dt)
        y = out[e - 1]
    return out


def gate_rates(v: np.ndarray, p) -> tuple[np.ndarray, np.ndarray]:
    """The a-gate's (k_on, k_off) at voltages v."""
    return (float(p[0]) * np.exp(float(p[1]) * v),
            float(p[2]) * np.exp(-float(p[3]) * v))


def lattice(name: str, n_points: int) -> np.ndarray:
    """The retained-sample indices of a recorded protocol."""
    v, _ = protorec.load_voltage(name)
    return np.flatnonzero(P.training_mask(v, n_points=n_points))[10::7]


def _save(d: str, **arrays) -> None:
    os.makedirs(d, exist_ok=True)
    for k, x in arrays.items():
        torch.save(torch.from_numpy(np.ascontiguousarray(x, np.float64)),
                   os.path.join(d, f"{k}.pt"))


def _a_parts(names, p, carry: bool):
    """(v, a, dadt, d2) at every sample of each protocol: p's a-gate from
    a = 0, carried from one protocol into the next when ``carry``."""
    parts, y0 = [], 0.0
    for name in names:
        v, dt = protorec.load_voltage(name)
        a = gate_trace(v, dt, p, y0 if carry else 0.0)
        kon, koff = gate_rates(v, p)
        dadt = kon - (kon + koff) * a
        parts.append((v, a, dadt, -(kon + koff) * dadt))
        y0 = a[-1]
    return parts


def write_r_caches(refdir: str) -> dict:
    """Write ``refdir/r1`` and ``refdir/r1-bad``; returns the number of
    retained points of each."""
    # r1: Pr3 + Pr5 on one clock, 7 ms mask
    names = ("pr3-cell5", "pr5-cell5")
    parts = _a_parts(names, HH_CELL5_FIT[:4], carry=False)
    idx = [lattice(n, 70) for n in names]
    dt = protorec.DT_MS
    n3 = parts[0][0].size
    t = np.concatenate([idx[0] * dt, (n3 - 1) * dt + idx[1] * dt])
    v, a, dadt, d2 = (np.concatenate([pt[k][i] for pt, i in zip(parts, idx)])
                      for k in range(4))
    a = a + np.random.RandomState(0).normal(0.0, R1_NOISE, a.size)
    _save(os.path.join(refdir, "r1"), t=t, v=v, a=a, dadt=dadt, d2adt2=d2)
    n_r1 = t.size

    # r1-bad: Pr3 + Pr4 carried, 3 ms mask, a scaled to the r0-bad model
    names = ("pr3-cell5", "pr4-cell5")
    parts = _a_parts(names, R1BAD_TRUTH, carry=True)
    idx = [lattice(n, 30) for n in names]
    v, a, dadt, d2 = (np.concatenate([pt[k][i] for pt, i in zip(parts, idx)])
                      for k in range(4))
    f = (v - R1BAD_E) / (v - float(CELL5_R1BAD.e))
    _save(os.path.join(refdir, "r1-bad"), v=v, a=a * f, dadt=dadt * f,
          d2adt2=d2 * f)
    return {"r1": n_r1, "r1-bad": v.size}


def r_gate(name: str, rgate) -> np.ndarray:
    """The known r-gate (p5-p8) at every sample of a protocol, from r = 1."""
    v, dt = protorec.load_voltage(name)
    return gate_trace(v, dt, rgate, 1.0, rgate=True)


def recovery_errors(surface_dir: str, got: dict, c, rgate) -> dict:
    """{name: (t_local_ms, err)} for a ``recover_measurements`` result
    ``got`` (either package's) of every protocol of the cache in
    ``surface_dir``, in the cache's order: each recovered current against
    a g r (V - E) with r the exact propagator's r-gate (p5-p8 of
    ``rgate``), as a fraction of that current's range."""
    v = torch.load(os.path.join(surface_dir, "v.pt")).numpy()
    a = torch.load(os.path.join(surface_dir, "a.pt")).numpy()
    out, at = {}, 0
    for name, (tl, i) in got.items():
        idx = np.round(np.asarray(tl) / protorec.DT_MS).astype(np.int64)
        sl = slice(at, at + idx.size)
        at += idx.size
        r = r_gate(f"{name}-cell5", rgate[4:])[idx]
        want = a[sl] * float(c.g) * r * (v[sl] - float(c.e))
        out[name] = (np.asarray(tl), np.abs(np.asarray(i) - want)
                     / np.ptp(want))
    return out



# Short stand-ins of the recorded protocols for the parity tests, at the
# recordings' 0.1 ms: two sweeps each with the recordings' segment order
# (leak step, holding, the test step; Pr5 and Pr4 after a +50 mV step),
# every segment at least 500 samples, as the recordings' are, so that each
# keeps more lattice points than the smoothing window of 51.
def _sweeps(layout, tests, period):
    rows = []
    for tv in tests:
        row = np.full(period, -80.0)
        at = 0
        for n, lvl in layout:
            row[at:at + n] = tv if lvl is None else lvl
            at += n
        rows.append(row)
    return np.concatenate(rows)


SHORT = {
    "pr3-cell5": (_sweeps([(600, -80.0), (500, -120.0), (600, -80.0),
                           (2000, None), (600, -40.0), (500, -120.0)],
                          (20.0, 40.0), 5400), 5400),
    "pr5-cell5": (_sweeps([(600, -80.0), (500, -120.0), (600, -80.0),
                           (1200, 50.0), (1400, None), (500, -120.0)],
                          (-100.0, -60.0), 5400), 5400),
    "pr4-cell5": (_sweeps([(600, -80.0), (500, -120.0), (600, -80.0),
                           (800, 50.0), (600, -90.0), (600, None),
                           (500, -120.0)], (-50.0, 0.0), 4800), 4800),
}


# ... and of the two single-segment recordings, 300 ms each
_T = np.arange(3000) * 0.1
SINGLE = {
    "sinewave-cell5": np.round(-30.0 + 54.0 * np.sin(0.007 * _T)
                               + 26.0 * np.sin(0.037 * _T), 3),
    "aps-cell5": np.where((_T % 150.0) < 40.0, 20.0 - (_T % 150.0), -80.0),
}


def short_voltage(name: str):
    v = SINGLE[name] if name in SINGLE else SHORT[name][0]
    return v, protorec.DT_MS


def patch_short(monkeypatch, *modules) -> None:
    """Point each protorec module (the port's, JAX's) at the short
    stand-ins: ``load_voltage``, ``SWEEPS`` and ``PR3_N``."""
    sweeps = {n: (v.size // p, p) for n, (v, p) in SHORT.items()}
    for mod in modules:
        monkeypatch.setattr(mod, "load_voltage", short_voltage)
        monkeypatch.setattr(mod, "SWEEPS", sweeps)
        monkeypatch.setattr(mod, "PR3_N", SHORT["pr3-cell5"][0].size)
