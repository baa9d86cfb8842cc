"""Continuous adjoint of the adaptive solver (counterpart of
``ionflux/solver/adjoint.py::odeint_adjoint``), as a
``torch.autograd.Function``.

Forward: ``odeint`` (dopri5, dense output at ``ts``).  Backward: the
augmented ODE

    d/dt [y, a_y, a_theta] = [f, -a_y^T df/dy, -a_y^T df/dtheta]

integrated backward interval by interval between output points, in the
reversed time tau = t1 - t of each interval, the output cotangent g_i
added to a_y at each point.  Only the states at the output points are
kept.  theta are the tensors of ``args`` that require grad (an nn.Module's
parameters included); the gradient with respect to ``ts`` is
dL/dt_i = g_i . f(t_i, y_i), and -a_y(t0) . f(t0, y0) at t0.

The backward branch follows JAX's count of the augmented state: 2 S plus
every floating value in ``args`` (each tensor's numel, a host float one),
whether or not it needs a gradient.  Past ``RK4_ABOVE`` the fixed-step
branch integrates only the leaves that need a gradient: the others' rows
never feed back into (y, a_y), so the numbers are JAX's.  Below it the
adaptive branch integrates every floating tensor leaf, as JAX does, since
the starting step's RMS (``dopri5._initial_step``) counts and weighs them
all; host floats and frozen module tensors ride as zero rows, so the
count, and with it every RMS's denominator, stays JAX's.

The augmented right-hand side (``_aug_rhs``) takes the interval's t1, the
solve's args and the cotangent's shape through its own args, never through
a closure, so on the card one captured graph serves every interval: the
adaptive backward solves replay ``odeint``'s block graph; an augmented
state past ``RK4_ABOVE`` (an MLP's parameters) integrates each interval by
``odeint_rk4`` with ``RK4_SUB`` substeps, captured once as a CUDA graph
(``_IntervalGraph``) and replayed for every later interval.  A capture that
fails raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ionflux_torch.ops._build import Graph
from ionflux_torch.solver.dopri5 import _clone, _fn_key, _structure, odeint
from ionflux_torch.solver.fixed import odeint_rk4

RK4_ABOVE = 8192    # augmented states past this take the fixed-step branch
RK4_SUB = 16        # its RK4 substeps per output interval


def _swap(x, sel: frozenset, pos: list, targets: dict):
    """x with each selected tensor leaf (``_structure``'s order) replaced by
    a detached copy that requires grad; targets[i] is what leaf i's
    gradient is taken with respect to (an nn.Module's own parameter)."""
    if isinstance(x, torch.Tensor):
        i = pos[0]
        pos[0] += 1
        if i in sel:
            x = targets[i] = x.detach().requires_grad_(True)
        return x
    if isinstance(x, nn.Module):
        for p in list(x.parameters()) + list(x.buffers()):
            if pos[0] in sel:
                targets[pos[0]] = p
            pos[0] += 1
        return x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_swap(v, sel, pos, targets) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_swap(v, sel, pos, targets) for v in x)
    if isinstance(x, dict):
        return {k: _swap(x[k], sel, pos, targets) for k in sorted(x)}
    return x


def _aug_rhs(tau, v, pk):
    """The augmented dynamics in reversed time tau = t1 - t.  pk = (t1,
    args, (fn, sel, s, pad)): v = [y (s), a_y (s), a_theta (the selected
    leaves, flat), pad zero rows]."""
    t1, args, (fn, sel, s, pad) = pk
    t = t1 - tau
    targets = {}
    with torch.enable_grad():
        y = v[:s].detach().requires_grad_(True)
        f = fn(t, y, _swap(args, sel, [0], targets))
        wrt = [y] + [targets[i] for i in sorted(sel)]
        grads = torch.autograd.grad(f, wrt, v[s:2 * s], allow_unused=True)
    parts = [-f.detach()] + [
        (torch.zeros_like(x) if g is None else g).reshape(-1)
        for x, g in zip(wrt, grads)]
    if pad:
        parts.append(v.new_zeros(pad))
    return torch.cat(parts)


def _float_values(x, frozen: list) -> int:
    """How many floating values x holds, as JAX counts a pytree's leaves:
    each floating tensor's numel (an nn.Module's parameters and buffers
    included) and one for each host float.  frozen gets, in
    ``_structure``'s leaf order, whether each tensor leaf is one autograd
    cannot differentiate in place (a module's tensor that does not require
    grad)."""
    if isinstance(x, torch.Tensor):
        frozen.append(False)
        return x.numel() if x.is_floating_point() else 0
    if isinstance(x, nn.Module):
        n = 0
        for p in list(x.parameters()) + list(x.buffers()):
            frozen.append(not p.requires_grad)
            n += p.numel() if p.is_floating_point() else 0
        return n
    if isinstance(x, (tuple, list)):
        return sum(_float_values(v, frozen) for v in x)
    if isinstance(x, dict):
        return sum(_float_values(x[k], frozen) for k in sorted(x))
    return 1 if isinstance(x, float) else 0


class _IntervalGraph:
    """The fixed-step branch's interval, ``odeint_rk4(_aug_rhs, v, [0,
    tau_end], pk, n_sub=RK4_SUB)[-1]``, captured as a CUDA graph on static
    copies of (v, tau_end, pk) and replayed."""

    def __init__(self, v, tau_end, pk):
        self.v, self.tau_end, self.pk = v.clone(), tau_end.clone(), _clone(pk)
        self.leaves = []
        _structure((self.v, self.tau_end, self.pk), self.leaves)
        try:
            self.graph = Graph(lambda *_: _rk4_interval(
                self.v, self.tau_end, self.pk))
        except RuntimeError as exc:
            raise RuntimeError(
                "odeint_adjoint: capturing the backward interval as a CUDA "
                "graph failed; the right-hand side must make no host read "
                f"or host-to-device copy ({exc})") from exc

    def run(self, v, tau_end, pk) -> torch.Tensor:
        leaves = []
        _structure((v, tau_end, pk), leaves)
        with torch.no_grad():
            for dst, src in zip(self.leaves, leaves):
                dst.copy_(src)
        return self.graph.replay().clone()


# Captured intervals by (augmented structure, shapes, device)
_INTERVAL_GRAPHS: dict = {}


def _rk4_interval(v, tau_end, pk):
    grid = torch.stack([torch.zeros_like(tau_end), tau_end])
    return odeint_rk4(_aug_rhs, v, grid, pk, n_sub=RK4_SUB,
                      checkpoint=False)[-1]


def _rk4_branch(v, tau_end, pk) -> torch.Tensor:
    """One backward interval by the fixed-step branch: eager on the CPU; on
    the card its first run eager, then a captured graph for every later
    interval of this shape."""
    if v.device.type != "cuda":
        return _rk4_interval(v, tau_end, pk)
    leaves = []
    key = (_fn_key(_aug_rhs), _structure((v, tau_end, pk), leaves),
           str(v.device), RK4_SUB)
    g = _INTERVAL_GRAPHS.get(key)
    if g is None:
        out = _rk4_interval(v, tau_end, pk)
        _INTERVAL_GRAPHS[key] = _IntervalGraph(v, tau_end, pk)
        return out
    return g.run(v, tau_end, pk)


class _Adjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, fn, args, settings, y0, ts, *leaves):
        rtol, atol, max_steps, buffer_size, _ = settings
        ys = odeint(fn, y0, ts, args, rtol=rtol, atol=atol,
                    max_steps=max_steps, buffer_size=buffer_size)
        ctx.fn, ctx.args, ctx.settings = fn, args, settings
        ctx.save_for_backward(ys, ts)
        return ys

    @staticmethod
    def backward(ctx, g):
        fn, args = ctx.fn, ctx.args
        rtol, atol, max_steps, buffer_size, seminorm = ctx.settings
        ys, ts = ctx.saved_tensors
        ts = ts.to(ys.dtype)
        leaves, frozen = [], []
        _structure(args, leaves)
        s = ys.shape[-1]
        n_aug = 2 * s + _float_values(args, frozen)   # JAX's count
        need = frozenset(i for i, x in enumerate(leaves)
                         if ctx.needs_input_grad[5 + i]
                         and x.is_floating_point())
        rk4 = n_aug > RK4_ABOVE
        sel = need if rk4 else frozenset(
            i for i, x in enumerate(leaves)
            if x.is_floating_point() and not frozen[i])
        n_sel = sum(leaves[i].numel() for i in sel)
        pad = 0 if rk4 else n_aug - 2 * s - n_sel
        weight = None
        if seminorm and n_aug > 2 * s and not rk4:
            weight = torch.cat([torch.ones(2 * s, dtype=ys.dtype,
                                           device=ys.device),
                                torch.zeros(n_aug - 2 * s, dtype=ys.dtype,
                                            device=ys.device)])
        a_y = torch.zeros_like(ys[0])
        a_args = torch.zeros(n_sel, dtype=ys.dtype, device=ys.device)
        rows = torch.zeros(n_sel + pad, dtype=ys.dtype, device=ys.device)
        meta = (fn, sel, s, pad)
        for i in range(ts.shape[0] - 2, -1, -1):
            t0, t1 = ts[i], ts[i + 1]
            a_y = a_y + g[i + 1]   # the output cotangent at t1
            v = torch.cat([ys[i + 1], a_y, rows])
            pk = (t1, args, meta)
            if rk4:
                out = _rk4_branch(v, t1 - t0, pk)
            else:
                grid = torch.stack([torch.zeros_like(t0), t1 - t0])
                out = odeint(_aug_rhs, v, grid, pk, rtol=rtol, atol=atol,
                             max_steps=max_steps, buffer_size=buffer_size,
                             error_weight=weight)[-1]
            a_y = out[s:2 * s]
            a_args = a_args + out[2 * s:2 * s + n_sel]
        a_y0 = a_y + g[0]

        dts = None
        if ctx.needs_input_grad[4]:
            f_at = torch.stack([fn(ts[i], ys[i], args)
                                for i in range(ts.shape[0])])
            dts = torch.einsum("ts,ts->t", g, f_at)
            dts[0] = -torch.dot(a_y0, f_at[0])
        grads = [None] * len(leaves)
        off = 0
        for i in sorted(sel):
            x = leaves[i]
            if i in need:
                grads[i] = a_args[off:off + x.numel()].reshape(x.shape)
            off += x.numel()
        return (None, None, None, a_y0, dts, *grads)


def odeint_adjoint(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args=None,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 4096,
    seminorm: bool = True,
) -> torch.Tensor:
    """Differentiable odeint: gradients with respect to y0, ts and the
    tensors in args that require grad, by the continuous adjoint.
    fn: (t, y, args) -> dy.

    seminorm=True (default) error-controls the backward solve on the
    (y, a_y) block only: the parameter block is pure quadrature and
    restarts at zero every interval, so its atol-dominated scale would
    otherwise force tiny steps (Kidger et al. 2021)."""
    leaves = []
    _structure(args, leaves)
    return _Adjoint.apply(fn, args,
                          (rtol, atol, max_steps, buffer_size, seminorm), y0,
                          ts, *leaves)
