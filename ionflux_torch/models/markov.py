"""3-state Markov ground-truth model (6 ODE variables c1, c2, i, ic1, ic2,
o; counterpart of ``ionflux/models/markov.py``).  The observable current
uses the open state: I = o * (V - E).  Parameters are host scalars, applied
as Python floats so an f32 tensor stays f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ionflux_torch.models.registry import MarkovParams

# Initial conditions: holding at -80 mV puts the channel in c2; holding at
# +40 mV in the inactivated state i.  Host-side numpy, as in the reference.
MARKOV_Y0_REST = np.array([0.0, 1.0, 0.0, 0.0, 0.0, 0.0], dtype=np.float32)
MARKOV_Y0_INACT = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=np.float32)


def markov_rates(p: MarkovParams, v: torch.Tensor):
    """a1, b1, bh, ah, a2, b2."""
    a1 = float(p.p1) * torch.exp(float(p.p2) * v)
    b1 = float(p.p3) * torch.exp(-float(p.p4) * v)
    bh = float(p.p5) * torch.exp(float(p.p6) * v)
    ah = float(p.p7) * torch.exp(-float(p.p8) * v)
    a2 = float(p.p9) * torch.exp(float(p.p10) * v)
    b2 = float(p.p11) * torch.exp(-float(p.p12) * v)
    return a1, b1, bh, ah, a2, b2


def markov_rhs(p: MarkovParams, t, y: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """d[c1, c2, i, ic1, ic2, o]/dt.  y: [..., 6]."""
    c1, c2, i, ic1, ic2, o = y.unbind(-1)
    a1, b1, bh, ah, a2, b2 = markov_rates(p, v)
    dc1 = a1 * c2 + ah * ic1 + b2 * o - (b1 + bh + a2) * c1
    dc2 = b1 * c1 + ah * ic2 - (a1 + bh) * c2
    di = a2 * ic1 + bh * o - (b2 + ah) * i
    dic1 = a1 * ic2 + bh * c1 + b2 * i - (b1 + ah + a2) * ic1
    dic2 = b1 * ic1 + bh * c2 - (ah + a1) * ic2
    do = a2 * c1 + ah * i - (b2 + bh) * o
    return torch.stack([dc1, dc2, di, dic1, dic2, do], dim=-1)
