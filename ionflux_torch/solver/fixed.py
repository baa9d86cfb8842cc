"""Fixed-step RK4 over the output grid (counterpart of
``ionflux/solver/fixed.py::odeint_rk4``): differentiable by autograd.

Each output interval takes ``n_sub`` classic RK4 steps.  With
``checkpoint=True`` every interval is rematerialised in the backward pass
(``torch.utils.checkpoint``, non-reentrant, in place of ``jax.checkpoint``):
only the state at each output point is kept, and the result and the
gradients equal ``checkpoint=False``'s bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint as _remat


def _rk4_step(rhs, t, y, h):
    k1 = rhs(t, y)
    k2 = rhs(t + 0.5 * h, y + 0.5 * h * k1)
    k3 = rhs(t + 0.5 * h, y + 0.5 * h * k2)
    k4 = rhs(t + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _interval(fn, args, n_sub: int, y, t0, t1):
    """n_sub RK4 steps from (t0, y) to t1."""
    rhs = lambda t, yy: fn(t, yy, args)  # noqa: E731
    h = (t1 - t0) / n_sub
    for i in range(n_sub):
        y = _rk4_step(rhs, t0 + i * h, y, h)
    return y


def odeint_rk4(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args=None,
    *,
    n_sub: int = 1,
    checkpoint: bool = True,
) -> torch.Tensor:
    """Classic RK4 with ``n_sub`` substeps per output interval.

    fn: (t, y, args) -> dy.  Returns ys [T, S]; differentiable with respect
    to y0 and every tensor in args that requires grad (an nn.Module's
    parameters included, where its forward uses them); each output interval
    is rematerialised when ``checkpoint``.  No host read: on the card it
    can run inside a CUDA-graph capture."""
    ts = ts.to(y0.dtype)
    ys = [y0]
    y = y0
    for k in range(ts.shape[0] - 1):
        if checkpoint and torch.is_grad_enabled():
            # no RNG state to keep (reading it cannot be captured)
            y = _remat(_interval, fn, args, n_sub, y, ts[k], ts[k + 1],
                       use_reentrant=False, preserve_rng_state=False)
        else:
            y = _interval(fn, args, n_sub, y, ts[k], ts[k + 1])
        ys.append(y)
    return torch.stack(ys)
