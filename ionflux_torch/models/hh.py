"""Candidate Hodgkin-Huxley IKr model (2 states: a activation, r recovery).

Counterpart of ``ionflux/models/hh.py``.  All functions broadcast over
leading batch dims: ``y`` has shape [..., 2], ``v`` shape [...].  Parameters
are host scalars, applied as Python floats so an f32 tensor stays f32.
"""

from __future__ import annotations

import torch

from ionflux_torch.models.registry import HHParams


def hh_rates(p: HHParams, v: torch.Tensor):
    """Voltage-dependent rates k1..k4."""
    k1 = float(p.p1) * torch.exp(float(p.p2) * v)
    k2 = float(p.p3) * torch.exp(-float(p.p4) * v)
    k3 = float(p.p5) * torch.exp(float(p.p6) * v)
    k4 = float(p.p7) * torch.exp(-float(p.p8) * v)
    return k1, k2, k3, k4


def hh_rhs(p: HHParams, t, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """d[a, r]/dt."""
    a = y[..., 0]
    r = y[..., 1]
    k1, k2, k3, k4 = hh_rates(p, v)
    dadt = k1 * (1.0 - a) - k2 * a
    drdt = -k3 * r + k4 * (1.0 - r)
    return torch.stack([dadt, drdt], dim=-1)


def a_gate_rhs(p: HHParams, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """da/dt alone: the NN-d base rate."""
    k1 = float(p.p1) * torch.exp(float(p.p2) * v)
    k2 = float(p.p3) * torch.exp(-float(p.p4) * v)
    return k1 * (1.0 - a) - k2 * a


def r_gate_rhs(p: HHParams, r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """dr/dt alone: the always-known recovery gate."""
    k3 = float(p.p5) * torch.exp(float(p.p6) * v)
    k4 = float(p.p7) * torch.exp(-float(p.p8) * v)
    return -k3 * r + k4 * (1.0 - r)


def hh_steady_state(p: HHParams, v: torch.Tensor) -> torch.Tensor:
    """Steady state [a_inf, r_inf] at constant voltage."""
    k1, k2, k3, k4 = hh_rates(p, v)
    return torch.stack([k1 / (k1 + k2), k4 / (k3 + k4)], dim=-1)


def hh_time_constants(p: HHParams, v: torch.Tensor) -> torch.Tensor:
    """Relaxation time constants [tau_a, tau_r] at constant voltage."""
    k1, k2, k3, k4 = hh_rates(p, v)
    return torch.stack([1.0 / (k1 + k2), 1.0 / (k3 + k4)], dim=-1)
