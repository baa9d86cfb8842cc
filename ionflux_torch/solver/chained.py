"""Segment-chained integration (counterpart of ``ionflux/solver/chained.py``):
solve a long concatenated recording as a loop of per-sweep solves on LOCAL
time axes, carrying the state across sweeps.

A single f32 time axis over 146 s of concatenated sweeps loses resolution
(ulp(146000 ms) ~ 0.016 ms), and steps near protocol edges stall.
Restarting the clock per sweep keeps f32 exact where it matters and restarts
the step controller at each sweep.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ionflux_torch.solver.dopri5 import odeint


def odeint_chained(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    segments,
    args=None,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 4096,
) -> torch.Tensor:
    """Integrate across stacked same-shape segments, chaining final states.

    fn: (t, y, (args, segment)) -> dy, with t LOCAL to the segment.
    ts: [T] local output grid shared by all segments.
    segments: a tensor, or a (named) tuple, list or dict of tensors, each
      with a leading segment axis [B, ...] (e.g. ``protocols.stack(...)`` of
      equal-length sweeps).
    Returns ys [B, T, S].  A diverged segment poisons its successors with
    inf (a whole-trace objective then rejects the parameters).
    """
    n_seg = tree_leaves(segments)[0].shape[0]
    y, out = y0, []
    for k in range(n_seg):
        segment = tree_map(lambda x: x[k], segments)
        if bool(torch.isfinite(y).all()):
            ys = odeint(fn, y, ts, (args, segment), rtol=rtol, atol=atol,
                        max_steps=max_steps, buffer_size=buffer_size)
        else:
            ys = torch.full((ts.shape[0],) + tuple(y0.shape), float("inf"),
                            dtype=y0.dtype, device=y0.device)
        out.append(ys)
        y = ys[-1]
    return torch.stack(out)
