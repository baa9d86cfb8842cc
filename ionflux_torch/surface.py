"""Derivative-surface estimation (counterpart of ``ionflux/surface.py``, its
scipy path): observed current -> (V, a, da/dt) training points.

  1. solve the known r-gate r(t) (only the a-gate is learned);
  2. per constant-voltage segment: Hanning-smooth the current, fit a cubic
     smoothing spline (scipy's FITPACK ``UnivariateSpline``, on the host as
     in the reference) and take its analytic derivative;
  3. invert the observation I = g a r (V - E) algebraically:
        a     = I / (g r (V - E))
        da/dt = r^-1 [ (dI/dt / g - a r dV/dt) / (V - E) - a dr/dt ]
     with dV/dt = 0;
  4. mask samples near voltage steps, then subsample [skip::sparse].

Offline data preparation: the r-gate solve runs on the protocol's device
through ``solver.odeint`` (device-paced on the card), everything after it
in numpy f64 on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.interpolate import UnivariateSpline

from ionflux_torch import protocols as P
from ionflux_torch.models.hh import r_gate_rhs
from ionflux_torch.models.registry import Constants, HHParams
from ionflux_torch.ops.smoothing import smooth_same_np
from ionflux_torch.solver import odeint


@dataclass(frozen=True)
class SurfaceConfig:
    """Pipeline constants (the reference's defaults; d2 widens them to
    window 151, s = 1, sparse 21)."""

    skip: int = 5
    sparse: int = 11
    smooth_window: int = 61
    spline_k: int = 3
    spline_s: float = 0.0


def _rhs_r(t, y, args):
    rg, pr = args
    return r_gate_rhs(rg, y, P.voltage(pr, t))


def solve_r_gate(proto: P.Protocol, ts: torch.Tensor, rgate: HHParams,
                 r0: float = 1.0, **kw) -> torch.Tensor:
    """The known r-gate alone, r(ts) [T] (r does not depend on a)."""
    y0 = torch.tensor([r0], dtype=ts.dtype, device=ts.device)
    return odeint(_rhs_r, y0, ts, (rgate, proto), rtol=1e-6, atol=1e-8,
                  **kw)[:, 0]


def spline_didt(t: np.ndarray, i: np.ndarray, edges: np.ndarray,
                cfg: SurfaceConfig = SurfaceConfig()):
    """Per-segment smooth + spline + derivative.  t, i: the full uniform
    grid and the observed current; edges: segment end times
    (``protocols.segment_edges``).  Returns (i_smooth, didt) on the grid;
    segments no longer than the smoothing window stay zero (they lie inside
    the step-edge masks)."""
    t = np.asarray(t, np.float64)
    i = np.asarray(i, np.float64).reshape(-1)
    io = np.zeros_like(t)
    didto = np.zeros_like(t)
    t_i = 0.0
    for t_f in edges:
        idx = np.where((t >= t_i) & (t < t_f))[0]
        if len(idx) <= cfg.smooth_window:
            t_i = t_f
            continue
        tfit = t[idx]
        ifit = smooth_same_np(i[idx], cfg.smooth_window)
        spl = UnivariateSpline(tfit, ifit, k=cfg.spline_k)
        spl.set_smoothing_factor(cfg.spline_s)
        io[idx] = spl(tfit)
        didto[idx] = spl.derivative()(tfit)
        t_i = t_f
    return io, didto


def invert_observation(i: np.ndarray, r: np.ndarray, v: np.ndarray,
                       didt: np.ndarray, drdt: np.ndarray, c: Constants,
                       dvdt: np.ndarray | float = 0.0):
    """Algebraic inversion of I = g a r (V - E) to (a, da/dt)."""
    g, e = np.float64(c.g), np.float64(c.e)
    a = i / (g * r * (v - e))
    dadt = (1.0 / r) * ((didt / g - a * r * dvdt) / (v - e) - a * drdt)
    return a, dadt


def estimate_gate_surface(proto: P.Protocol, ts: torch.Tensor,
                          current: np.ndarray, rgate: HHParams,
                          c: Constants, mask: np.ndarray,
                          cfg: SurfaceConfig = SurfaceConfig()):
    """The whole per-protocol pipeline -> subsampled (v, a, dadt) numpy
    f64 arrays."""
    t_np = ts.double().cpu().numpy()
    v_np = P.voltage(proto, ts).double().cpu().numpy()
    r_np = solve_r_gate(proto, ts, rgate).double().cpu().numpy()

    k3 = np.float64(rgate.p5) * np.exp(np.float64(rgate.p6) * v_np)
    k4 = np.float64(rgate.p7) * np.exp(-np.float64(rgate.p8) * v_np)
    drdt = -k3 * r_np + k4 * (1.0 - r_np)

    edges = P.segment_edges(proto.times().double().cpu().numpy(),
                            proto.v.double().cpu().numpy())
    i_smooth, didt = spline_didt(t_np, current, edges, cfg)
    a, dadt = invert_observation(i_smooth, r_np, v_np, didt, drdt, c)

    sl = slice(cfg.skip, None, cfg.sparse)
    return v_np[mask][sl], a[mask][sl], dadt[mask][sl]


def concat_surfaces(parts):
    """Per-protocol (v, a, dadt) parts -> flat training arrays."""
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))
