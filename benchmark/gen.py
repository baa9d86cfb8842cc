"""The benchmark's inputs, made from a traffic mix's parameters and the
seed: recorded voltage protocols, member populations around a checkpoint,
target traces, training surfaces and initial weights.  Random draws come
from a ``torch.Generator`` on the run's device, seeded with ``--seed``, in a
few large calls; the same seed gives the same inputs."""

from __future__ import annotations

import os

import numpy as np
import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def path(rel: str) -> str:
    """A repository-relative path of the benchmark's own data."""
    return os.path.join(ROOT, rel)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The seed's generator for one stream of draws (streams keep one
    input's draws from shifting another's)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def step_recording(spec: dict) -> np.ndarray:
    """A multi-sweep step protocol: ``hold_mv`` everywhere, then from sample
    ``first`` every ``period`` samples one sweep per ``test_mv`` entry, the
    sweep's levels from ``sweep`` ([[offset, mV or "test"], ...]), each
    level held until the next offset (the last one until the next sweep)."""
    v = np.full(int(spec["n"]), float(spec["hold_mv"]), np.float64)
    for k, tv in enumerate(spec["test_mv"]):
        s = int(spec["first"]) + k * int(spec["period"])
        for off, level in spec["sweep"]:
            v[s + int(off):] = float(tv) if level == "test" else float(level)
    return v


def recording(spec: dict) -> tuple[np.ndarray, float]:
    """(voltage samples, dt ms) of a recording: a step protocol or a
    waveform stored under the benchmark's data."""
    if "file" in spec:
        with np.load(path(spec["file"])) as z:
            return z["v"].astype(np.float64), float(z["dt"])
    return step_recording(spec), float(spec["dt_ms"])


def npz_leaves(rel: str) -> list[np.ndarray]:
    """A checkpoint's leaves in order: (W, b) pairs, then 8 gate scalars."""
    with np.load(path(rel)) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def population(leaves, members: int, spread: float, seed: int, device):
    """Layers [(W [P, in, out], b [P, out])] of ``members`` copies of a
    checkpoint's net, each leaf times (1 + spread N(0, 1)), float32 on the
    device, and the 8 gate scalars shared by all members."""
    net, gate = leaves[:-8], leaves[-8:]
    gen = generator(seed, device, stream=1)
    flat = torch.cat([torch.as_tensor(x, dtype=torch.float32).reshape(-1)
                      for x in net]).to(device)
    noise = torch.randn((members, flat.numel()), generator=gen,
                        device=device, dtype=torch.float32)
    pop = flat[None] * (1.0 + spread * noise)
    layers, at = [], 0
    for w, b in zip(net[0::2], net[1::2]):
        nw, nb = w.size, b.size
        layers.append((pop[:, at:at + nw].reshape(members, *w.shape)
                       .contiguous(),
                       pop[:, at + nw:at + nw + nb].reshape(members, *b.shape)
                       .contiguous()))
        at += nw + nb
    return layers, [float(np.float32(x.reshape(-1)[0])) for x in gate]


def noise_traces(lengths, sigma: float, seed: int, device) -> list:
    """Target traces sigma N(0, 1), float32, one per length, drawn in one
    call."""
    gen = generator(seed, device, stream=2)
    flat = sigma * torch.randn(int(sum(lengths)), generator=gen,
                               device=device, dtype=torch.float32)
    return list(torch.split(flat, list(lengths)))


def mlp_weights(sizes, std: float, seed: int, device) -> list:
    """[(W [in, out] std N(0, 1), b [out] zero)] of an MLP, drawn in one
    call, float32."""
    gen = generator(seed, device, stream=3)
    n = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    flat = std * torch.randn(n, generator=gen, device=device,
                             dtype=torch.float32)
    layers, at = [], 0
    for a, b in zip(sizes[:-1], sizes[1:]):
        layers.append((flat[at:at + a * b].reshape(a, b).contiguous(),
                       torch.zeros(b, dtype=torch.float32, device=device)))
        at += a * b
    return layers
