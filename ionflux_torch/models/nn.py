"""Neural-ODE gate models: NN-f (full) and NN-d (discrepancy).

Counterpart of ``ionflux/models/nn.py``:

- NN-f replaces da/dt with an MLP: dadt = net([V/100, a]) / 1000.
- NN-d adds the MLP to the analytic HH rate: dadt = hh_dadt(a, V) + net(...)/1000.

The MLP is an ``nn.Module`` holding the reference's layout: weights
W [in, out] and biases b [out] (``x @ W + b``, not ``nn.Linear``'s
[out, in]), so checkpoints carry over leaf for leaf.  A population keeps a
leading member axis on every leaf: W [P, in, out], b [P, out].
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ionflux_torch._device import resolve_device
from ionflux_torch.models.hh import a_gate_rhs, r_gate_rhs
from ionflux_torch.models.registry import HHParams, NETSCALE, VRANGE

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU default negative_slope


def mlp_sizes(n_layers: int = 5, n_nodes: int = 200) -> list[int]:
    """Linear(2,n) + n_layers x Linear(n,n) + Linear(n,1)."""
    return [2] + [n_nodes] * (n_layers + 1) + [1]


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             std: float = 0.1, device=None):
    """List of (W [in, out], b [out]) with N(0, std^2) weights drawn from
    ``generator`` (a CPU generator; the stream differs from
    ``jax.random``'s) and zero biases."""
    device = resolve_device(device)
    layers = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        w = std * torch.randn(d_in, d_out, generator=generator,
                              dtype=torch.float32)
        layers.append((w.to(device),
                       torch.zeros(d_out, dtype=torch.float32,
                                   device=device)))
    return layers


class MLP(nn.Module):
    """LeakyReLU MLP with weights [..., in, out] and biases [..., out]."""

    def __init__(self, layers: Sequence[tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.weights = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w, _ in layers])
        self.biases = nn.ParameterList(
            [nn.Parameter(b, requires_grad=False) for _, b in layers])

    @classmethod
    def init(cls, sizes: Sequence[int], generator: torch.Generator,
             std: float = 0.1, device=None) -> "MLP":
        """N(0, std^2) weights, zero biases (``mlp_init``)."""
        return cls(mlp_init(generator, sizes, std, device))

    @property
    def layers(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return [(w.data, b.data) for w, b in zip(self.weights, self.biases)]

    @property
    def members(self) -> int | None:
        """Population size P, or None for a single net."""
        w0 = self.weights[0]
        return int(w0.shape[0]) if w0.dim() == 3 else None

    def member(self, m: int) -> "MLP":
        return MLP([(w[m], b[m]) for w, b in self.layers])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.layers, x)


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU MLP on a list of (W, b). x: [..., d_in] -> [..., d_out]."""
    if isinstance(layers, MLP):
        layers = layers.layers
    for w, b in layers[:-1]:
        x = x @ w + b
        x = torch.where(x >= 0, x, LEAKY_SLOPE * x)
    w, b = layers[-1]
    return x @ w + b


class NNfParams(NamedTuple):
    """NN-f: learned a-gate MLP + fixed analytic r-gate (p5-p8)."""

    net: MLP
    rgate: HHParams  # only p5-p8 are used


class NNdParams(NamedTuple):
    """NN-d: analytic HH a-gate (p1-p4) + MLP correction + r-gate (p5-p8)."""

    net: MLP
    hh: HHParams


def nnf_init(generator: torch.Generator, rgate: HHParams, n_layers: int = 5,
             n_nodes: int = 200, std: float = 0.1, device=None) -> NNfParams:
    return NNfParams(MLP.init(mlp_sizes(n_layers, n_nodes), generator, std,
                              device), rgate)


def nnd_init(generator: torch.Generator, hh: HHParams, n_layers: int = 5,
             n_nodes: int = 200, std: float = 1e-3, device=None) -> NNdParams:
    return NNdParams(MLP.init(mlp_sizes(n_layers, n_nodes), generator, std,
                              device), hh)


def nn_surface(net, v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """da/dt predicted by the MLP on raw (V, a): net([V/100, a]) / 1000."""
    x = torch.stack([v / VRANGE, a], dim=-1)
    return mlp_apply(net, x)[..., 0] / NETSCALE


def nnd_surface(p: NNdParams, v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """NN-d total da/dt surface: analytic HH + MLP correction."""
    return a_gate_rhs(p.hh, a, v) + nn_surface(p.net, v, a)


def nnf_rhs(p: NNfParams, t, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """NN-f d[a, r]/dt. y: [..., 2], v: [...]."""
    dadt = nn_surface(p.net, v, y[..., 0])
    drdt = r_gate_rhs(p.rgate, y[..., 1], v)
    return torch.stack([dadt, drdt], dim=-1)


def nnd_rhs(p: NNdParams, t, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """NN-d d[a, r]/dt. y: [..., 2], v: [...]."""
    dadt = nnd_surface(p, v, y[..., 0])
    drdt = r_gate_rhs(p.hh, y[..., 1], v)
    return torch.stack([dadt, drdt], dim=-1)
