"""Current observation and error metrics (counterpart of
``ionflux/observe.py``): I(t) = g * a(t) * r(t) * (V(t) - E)."""

from __future__ import annotations

import torch

from ionflux_torch.models.registry import Constants

# Observation noise (nA) of the synthetic studies.
NOISE_SIGMA = 0.1


def gate_current(y: torch.Tensor, v: torch.Tensor, c: Constants) -> torch.Tensor:
    """I = g * a * r * (V - E). y: [..., 2] -> [...]."""
    return float(c.g) * y[..., 0] * y[..., 1] * (v - float(c.e))


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error, the reference's canonical metric."""
    return torch.mean(torch.abs(a - b))


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((a - b) ** 2))
