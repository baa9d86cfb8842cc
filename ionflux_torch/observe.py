"""Current observation, measurement noise and error metrics (counterpart of
``ionflux/observe.py``): I(t) = g * a(t) * r(t) * (V(t) - E) for the 2-state
gate models, g * o(t) * (V(t) - E) for the 6-state Markov model."""

from __future__ import annotations

import torch

from ionflux_torch.models.registry import Constants

# Observation noise (nA) of the synthetic studies.
NOISE_SIGMA = 0.1


def gate_current(y: torch.Tensor, v: torch.Tensor, c: Constants) -> torch.Tensor:
    """I = g * a * r * (V - E). y: [..., 2] -> [...]."""
    return float(c.g) * y[..., 0] * y[..., 1] * (v - float(c.e))


def markov_current(y: torch.Tensor, v: torch.Tensor,
                   c: Constants) -> torch.Tensor:
    """I = g * o * (V - E) for the 6-state Markov model (o is state -1)."""
    return float(c.g) * y[..., -1] * (v - float(c.e))


def add_noise(generator: torch.Generator, i: torch.Tensor,
              sigma: float = NOISE_SIGMA) -> torch.Tensor:
    """i + sigma N(0, 1), the noise drawn from ``generator`` (a
    ``torch.Generator`` on i's device, where the reference takes a PRNG key;
    the two streams differ, so tests copy noise across)."""
    noise = torch.randn(i.shape, generator=generator, dtype=i.dtype,
                        device=i.device)
    return i + sigma * noise


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error, the reference's canonical metric."""
    return torch.mean(torch.abs(a - b))


def rmse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((a - b) ** 2))
