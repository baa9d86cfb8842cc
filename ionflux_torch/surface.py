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
in numpy f64 on the host.  ``estimate_gate_surface_ondevice`` is the s = 0
variant with every step on the device: the Hanning convolution, the
not-a-knot interpolating spline's derivative (``ops/spline.py``: one Thomas
launch, K1, for all segments) and the inversion in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.interpolate import UnivariateSpline, make_interp_spline

from ionflux_torch import protocols as P
from ionflux_torch.models.hh import r_gate_rhs
from ionflux_torch.models.registry import Constants, HHParams
from ionflux_torch.ops.smoothing import smooth_same, smooth_same_np
from ionflux_torch.ops.spline import (spline_derivative,
                                      spline_derivative_segments)
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
    the step-edge masks).  With s = 0 the spline is the interpolating one,
    which FITPACK's s = 0 fit gives with not-a-knot knots; it is built by
    ``make_interp_spline`` (equal to machine precision), because scipy 1.18's
    ``UnivariateSpline.set_smoothing_factor(0)`` refuses it ("internal
    repeated knots")."""
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
        if cfg.spline_s == 0.0:
            spl = make_interp_spline(tfit, ifit, k=cfg.spline_k)
        else:
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


def spline_didt_segment_jax(i_seg: torch.Tensor, dt: float,
                            smooth_window: int = 61):
    """Per-segment smooth + interpolating-spline derivative on the device:
    one spline_didt loop iteration (Hanning convolution + not-a-knot cubic
    spline).  The torch version of the JAX function of this name.  Returns
    (i_smooth, didt)."""
    i_sm = smooth_same(i_seg, smooth_window)
    return i_sm, spline_derivative(i_sm, dt)


def smoothed_segments(proto: P.Protocol, ts: torch.Tensor,
                      current: torch.Tensor, smooth_window: int):
    """The constant-voltage segments longer than the smoothing window, as
    (start, end) sample spans, and the Hanning-smoothed current on each."""
    t_np = ts.double().cpu().numpy()
    edges = P.segment_edges(proto.times().double().cpu().numpy(),
                            proto.v.double().cpu().numpy())
    spans, lo = [], 0
    for t_f in edges:
        hi = int(np.searchsorted(t_np, t_f, side="left"))
        if hi - lo > smooth_window:
            spans.append((lo, hi))
        lo = hi
    return spans, [smooth_same(current[a:b], smooth_window)
                   for a, b in spans]


def estimate_gate_surface_ondevice(proto: P.Protocol, ts: torch.Tensor,
                                   current: torch.Tensor, rgate: HHParams,
                                   c: Constants, mask: np.ndarray,
                                   cfg: SurfaceConfig = SurfaceConfig()):
    """``estimate_gate_surface`` (its s = 0 path) with every step on the
    protocol's device in float32: the r-gate solve, per segment longer than
    the window the Hanning convolution, then the not-a-knot spline
    derivative of all of them in one Thomas launch, and the inversion.
    Returns the subsampled (v, a, dadt) as numpy arrays."""
    if cfg.spline_s != 0.0:
        raise ValueError("on-device path implements the s=0 spline only")
    t_np = ts.double().cpu().numpy()
    v = P.voltage(proto, ts)
    r = solve_r_gate(proto, ts, rgate)
    k3 = float(rgate.p5) * torch.exp(float(rgate.p6) * v)
    k4 = float(rgate.p7) * torch.exp(-float(rgate.p8) * v)
    drdt = -k3 * r + k4 * (1.0 - r)

    dt = float(t_np[1] - t_np[0])
    current = torch.as_tensor(current, device=ts.device).to(torch.float32)
    spans, smoothed = smoothed_segments(proto, ts, current,
                                        cfg.smooth_window)
    i_sm = torch.zeros_like(current)
    didt = torch.zeros_like(current)
    for (a, b), seg_sm, seg_d in zip(
            spans, smoothed, spline_derivative_segments(smoothed, dt)):
        i_sm[a:b] = seg_sm
        didt[a:b] = seg_d
    g, e = float(c.g), float(c.e)
    a = i_sm / (g * r * (v - e))
    dadt = (1.0 / r) * ((didt / g) / (v - e) - a * drdt)
    sl = slice(cfg.skip, None, cfg.sparse)
    mask = np.asarray(mask)
    return tuple(x.cpu().numpy()[mask][sl] for x in (v, a, dadt))


def concat_surfaces(parts):
    """Per-protocol (v, a, dadt) parts -> flat training arrays."""
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))
