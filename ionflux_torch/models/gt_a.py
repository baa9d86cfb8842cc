"""Second-order scalar-ODE reduction of the 3-state Markov a-gate
(counterpart of ``ionflux/models/gt_a.py``).

State (a, u = da/dt) with du/dt = -K1 a - K2 u + K3, where K1..K3 derive
from the Markov rates a1, b1, a2, b2.  Used for the phase-portrait figures.
Parameters are host scalars, applied as Python floats so an f32 tensor
stays f32.
"""

from __future__ import annotations

import torch

from ionflux_torch.models.registry import MarkovParams


def gt_a_coeffs(p: MarkovParams, v: torch.Tensor):
    """K1, K2, K3 of the reduced second-order a-gate ODE."""
    a1 = float(p.p1) * torch.exp(float(p.p2) * v)
    b1 = float(p.p3) * torch.exp(-float(p.p4) * v)
    a2 = float(p.p9) * torch.exp(float(p.p10) * v)
    b2 = float(p.p11) * torch.exp(-float(p.p12) * v)
    k1 = a1 * a2 + a1 * b2 + b1 * b2
    k2 = a1 + b1 + a2 + b2
    k3 = a1 * a2
    return k1, k2, k3


def gt_a_rhs(p: MarkovParams, t, y: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """d[a, u]/dt with u = da/dt.  y: [..., 2]."""
    a, u = y[..., 0], y[..., 1]
    k1, k2, k3 = gt_a_coeffs(p, v)
    return torch.stack([u, -k1 * a - k2 * u + k3], dim=-1)
