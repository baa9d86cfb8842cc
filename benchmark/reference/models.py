"""The plain gate models of the configurations (Lei & Mirams 2021), written
from the paper's equations and nothing of the program:

- the MLP: x @ W + b with LeakyReLU (slope 0.01) between layers, input
  (V / 100, a), output divided by 1000 (ms^-1);
- NN-f (M1): da/dt = MLP(V / 100, a) / 1000;
- NN-d (M2): da/dt = k1 (1 - a) - k2 a + MLP(V / 100, a) / 1000, with
  k1 = p1 exp(p2 V), k2 = p3 exp(-p4 V);
- the known r-gate of both: dr/dt = -k3 r + k4 (1 - r), k3 = p5 exp(p6 V),
  k4 = p7 exp(-p8 V);
- the current I = g a r (V - E).

Weights carry a leading member axis where a population is solved: W [P,
in, out], b [P, out], x [P, rows, in].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LEAKY_SLOPE = 0.01
V_SCALE = 100.0
OUT_SCALE = 1000.0


def mlp(layers, x: torch.Tensor, products=None) -> torch.Tensor:
    """The MLP on x [..., in]; batched weights take x [P, rows, in].
    ``products`` (a dtype) rounds each product's operands to it, the sums
    staying in x's dtype."""
    for i, (w, b) in enumerate(layers):
        if products is not None:
            x = x.to(products).to(b.dtype)
            w = w.to(products).to(b.dtype)
        if w.dim() == 3:
            x = torch.baddbmm(b[:, None, :], x, w)
        elif x.dim() == 2:
            x = torch.addmm(b, x, w)
        else:
            x = x @ w + b
        if i < len(layers) - 1:
            x = F.leaky_relu(x, LEAKY_SLOPE)
    return x


def net_rate(layers, v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """MLP(V / 100, a) / 1000 over matching v, a (batched: [P, rows])."""
    x = torch.stack([v / V_SCALE, a], dim=-1)
    return mlp(layers, x)[..., 0] / OUT_SCALE


def a_rate(p, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The analytic a-gate rate with p = (p1, ..., p8)."""
    k1 = p[0] * torch.exp(p[1] * v)
    k2 = p[2] * torch.exp(-p[3] * v)
    return k1 * (1.0 - a) - k2 * a


def r_rate(p, r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The analytic r-gate rate with p = (p1, ..., p8)."""
    k3 = p[4] * torch.exp(p[5] * v)
    k4 = p[6] * torch.exp(-p[7] * v)
    return -k3 * r + k4 * (1.0 - r)


def gate_rhs(kind: str, layers, p, y: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """d[a, r]/dt of NN-f ("nnf") or NN-d ("nnd"); y [..., 2], v [...]."""
    a, r = y[..., 0], y[..., 1]
    da = net_rate(layers, v, a)
    if kind == "nnd":
        da = da + a_rate(p, a, v)
    elif kind != "nnf":
        raise ValueError(f"unknown model kind {kind!r}")
    return torch.stack([da, r_rate(p, r, v)], dim=-1)


def current(y: torch.Tensor, v: torch.Tensor, g: float,
            e: float) -> torch.Tensor:
    """I = g a r (V - E)."""
    return g * y[..., 0] * y[..., 1] * (v - e)


def interp(v: torch.Tensor, dt: float, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of samples v [N] at spacing dt to times t (any
    shape, float64), held at the ends."""
    n = v.shape[-1]
    x = (t / dt).clamp(0.0, n - 1.0)
    i = x.floor().to(torch.int64).clamp(max=n - 2)
    w = (x - i.to(x.dtype)).to(v.dtype)
    lo, hi = torch.take(v, i), torch.take(v, i + 1)
    return lo + w * (hi - lo)
