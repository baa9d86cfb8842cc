"""Adaptive implicit (stiff) solver: the L-stable Rosenbrock(2,3) pair of
Shampine & Reichelt (MATLAB's ``ode23s``; SIAM J. Sci. Comput. 18(1):1-22,
1997).  Counterpart of ``ionflux/solver/implicit.py::odeint_rosenbrock``.

One Jacobian and one factorisation of (I - h d J) per step, three small
linear solves, no Newton iteration.  The Jacobians come from autodiff,
``torch.func.jacrev`` in y and in t (df/dt through the protocol's linear
interpolation; its floor and lookup give no gradient).  Forward mode
(``jacfwd``, the reference's) is not used: PyTorch's forward-mode tangent of
a 0-d tensor divided by a Python float comes out in float64 (the models'
``v / VRANGE``, ``/ NETSCALE``), which breaks the MLP's matmul.  The
three solves share one LU factorisation, ``torch.linalg.lu_factor_ex``
with ``check_errors=False`` and ``lu_solve`` (the reference calls
``jnp.linalg.solve`` three times): ``torch.linalg.solve`` reads its status
on the host and cannot be captured in a CUDA graph, these can
(``scripts/probe_solve_capture_torch.py``).  Dense output is cubic Hermite
on each accepted step's endpoints, for every output time at once.

The step loop is device-paced like ``odeint``'s (``dopri5._run_blocks``):
blocks of ``BLOCK_STEPS`` attempts, one host read per block, each block a
replayed CUDA graph on the card.  ``_rosenbrock_stepwise`` keeps the
per-step loop as the reference; both share ``_attempt`` and agree bit for
bit.

float32 floor: the order-2 error estimate sinks into rounding below rtol
~1e-5 on multi-second ranges (the controller then thrashes); run tighter
solves in float64 or use dopri5 / vcabm.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ionflux_torch.solver.dopri5 import (BLOCK_STEPS, SolveStats,
                                         _initial_step, _rms, _run_blocks)

# ode23s constants (Shampine & Reichelt 1997, eqs. 5-6)
_D = 1.0 / (2.0 + 2.0 ** 0.5)
_E32 = 6.0 + 2.0 ** 0.5

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0


def _solve(lu, piv, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]


def _ros23_step(rhs, t, y, f0, h):
    """One Rosenbrock(2,3) step: y1, f1 (FSAL), err [S]."""
    n = y.shape[0]
    jac = torch.func.jacrev(rhs, argnums=1)(t, y)          # [S, S]
    dfdt = torch.func.jacrev(rhs, argnums=0)(t, y)         # [S]
    w = torch.eye(n, dtype=y.dtype, device=y.device) - (h * _D) * jac
    # one factorisation, no status read (a singular w gives non-finite k,
    # which rejects the step)
    lu, piv, _ = torch.linalg.lu_factor_ex(w, check_errors=False)
    hdt = (h * _D) * dfdt
    k1 = _solve(lu, piv, f0 + hdt)
    fh = rhs(t + 0.5 * h, y + 0.5 * h * k1)
    k2 = _solve(lu, piv, fh - k1) + k1
    y1 = y + h * k2
    f1 = rhs(t + h, y1)
    k3 = _solve(lu, piv, f1 - _E32 * (k2 - fh) - 2.0 * (k1 - f0) + hdt)
    err = (h / 6.0) * (k1 - 2.0 * k2 + k3)
    return y1, f1, err


class _Consts(NamedTuple):
    rtol: torch.Tensor
    atol: torch.Tensor
    t_end: torch.Tensor
    h_min: torch.Tensor
    bp: torch.Tensor | None
    dt_max: float | None


class _State(NamedTuple):
    """The solve's state and its records on the device (``buffer_size + 1``
    slots)."""

    t: torch.Tensor        # 0-d
    y: torch.Tensor        # [S]
    f: torch.Tensor        # [S]
    h: torch.Tensor        # 0-d
    n_acc: torch.Tensor    # 0-d int64
    n_step: torch.Tensor   # 0-d int64
    stop: torch.Tensor     # 0-d bool
    rec_t: torch.Tensor    # [buffer_size + 1]
    rec_h: torch.Tensor    # [buffer_size + 1]
    rec_e: torch.Tensor    # [buffer_size + 1, 4, S]: y0, f0, y1, f1


def _setup(rhs, y0, ts, rtol, atol, buffer_size, breakpoints, dt_max):
    dtype, dev = y0.dtype, y0.device
    t0, t_end = ts[0], ts[-1]
    bp = None
    if breakpoints is not None:
        bp = torch.cat([breakpoints.to(dtype).reshape(-1),
                        torch.full((1,), torch.finfo(dtype).max,
                                   dtype=dtype, device=dev)])
    c = _Consts(torch.tensor(rtol, dtype=dtype, device=dev),
                torch.tensor(atol, dtype=dtype, device=dev), t_end,
                torch.clamp(t_end - t0, min=1.0) * 1e-12, bp, dt_max)
    f0 = rhs(t0, y0)
    h = _initial_step(rhs, t0, y0, f0, c.rtol, c.atol)
    if dt_max is not None:
        h = torch.clamp(h, max=dt_max)
    n = buffer_size + 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = _State(t0.clone(), y0.clone(), f0, h, zero, zero.clone(),
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros(n, dtype=dtype, device=dev),
                torch.ones(n, dtype=dtype, device=dev),
                torch.zeros((n, 4) + tuple(y0.shape), dtype=dtype,
                            device=dev))
    return c, st


def _attempt(rhs, t, y, f, h, c: _Consts):
    """One attempt: (y1, f1, h_eff, accept, t_new, h_new, dead)."""
    h_eff = torch.minimum(h, c.t_end - t)
    if c.bp is not None:
        nxt = torch.take(c.bp, torch.searchsorted(c.bp, t.reshape(1),
                                                  right=True))[0]
        h_eff = torch.minimum(h_eff, nxt - t)
    h_eff = torch.maximum(h_eff, c.h_min)

    y1, f1, err = _ros23_step(rhs, t, y, f, h_eff)
    scale = c.atol + c.rtol * torch.maximum(torch.abs(y), torch.abs(y1))
    ratio = _rms(err / scale)
    finite = torch.all(torch.isfinite(y1)) & torch.isfinite(ratio)
    accept = (ratio <= 1.0) & finite
    t_new = torch.where(accept, t + h_eff, t)

    # third-order error estimate -> -1/3 controller exponent
    factor = SAFETY * torch.pow(torch.clamp(ratio, min=1e-10), -1.0 / 3.0)
    factor = torch.where(torch.isfinite(factor), factor,
                         torch.full_like(factor, MIN_FACTOR))
    max_up = torch.where(accept, torch.full_like(factor, MAX_FACTOR),
                         torch.ones_like(factor))
    h_new = h_eff * torch.minimum(torch.clamp(factor, min=MIN_FACTOR),
                                  max_up)
    if c.dt_max is not None:
        h_new = torch.clamp(h_new, max=c.dt_max)
    dead = ~torch.isfinite(ratio) & (h_eff <= c.h_min * 2)
    return y1, f1, h_eff, accept, t_new, h_new, dead


def _block(rhs, st: _State, c: _Consts, max_steps: int,
           buffer_size: int) -> None:
    """BLOCK_STEPS attempts of the solve in st, updated in place; no host
    read.  A stopped solve's attempts change nothing."""
    t, y, f, h, n_acc, n_step, stop = st[:7]
    for _ in range(BLOCK_STEPS):
        y1, f1, h_eff, accept, t_new, h_new, dead = _attempt(rhs, t, y, f,
                                                             h, c)
        slot = n_acc.reshape(1)
        st.rec_t.index_copy_(0, slot, t.reshape(1))
        st.rec_h.index_copy_(0, slot, h_eff.reshape(1))
        st.rec_e.index_copy_(0, slot, torch.stack([y, f, y1, f1])[None])
        live = ~stop
        take = accept & live
        y = torch.where(take, y1, y)
        f = torch.where(take, f1, f)
        n_acc = n_acc + take.to(torch.int64)
        t = torch.where(live, t_new, t)
        h = torch.where(live, h_new, h)
        n_step = n_step + live.to(torch.int64)
        dead = dead | (n_step >= max_steps) | (n_acc >= buffer_size)
        stop = stop | (live & ((t_new >= c.t_end) | dead))
    for dst, src in zip(st[:7], (t, y, f, h, n_acc, n_step, stop)):
        dst.copy_(src)


def _dense(ts, y0, rec_t, rec_h, rec_e, n_acc: int, ok: bool):
    """Phase 2: cubic Hermite on the accepted steps (inf unless ok)."""
    if not ok:
        return torch.full((ts.shape[0],) + tuple(y0.shape), float("inf"),
                          dtype=y0.dtype, device=y0.device)
    bt = rec_t[:n_acc]
    idx = torch.clamp(torch.searchsorted(bt, ts, right=True) - 1, 0,
                      n_acc - 1)
    hh = rec_h[idx]
    th = torch.clamp((ts - bt[idx]) / hh, 0.0, 1.0)
    e = rec_e[idx]                                         # [T, 4, S]
    t2 = th * th
    t3 = t2 * th
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + th
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    ys = (h00[:, None] * e[:, 0] + (h10 * hh)[:, None] * e[:, 1]
          + h01[:, None] * e[:, 2] + (h11 * hh)[:, None] * e[:, 3])
    ys[0] = y0
    return ys


def _finish(ts, y0, t, y, n_acc, n_step, c, return_stats, records):
    ok = (bool(t >= c.t_end) and bool(torch.all(torch.isfinite(y)))
          and n_acc > 0)
    ys = _dense(ts, y0, *records, n_acc, ok)
    if return_stats:
        return ys, SolveStats(ok=ok, n_accepted=n_acc, n_steps=n_step)
    return ys


def odeint_rosenbrock(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args=None,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 4096,
    breakpoints: torch.Tensor | None = None,
    dt_max: float | None = None,
    return_stats: bool = False,
):
    """Integrate dy/dt = fn(t, y, args) with the implicit Rosenbrock(2,3)
    pair; the contract of ``odeint`` (ts ascending [T], ys [T, S], all inf
    and ok=False on failure).  For stiff vector fields, where dopri5's
    stability limit and not its accuracy sets the step; a step costs the
    Jacobians' S + 1 backward passes and three S x S solves.  On a CUDA
    device fn must be capturable, as ``odeint``'s."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    ts = ts.to(y0.dtype)
    c, st = _setup(rhs, y0, ts, rtol, atol, buffer_size, breakpoints, dt_max)
    st = _run_blocks(
        lambda r, s, cc: _block(r, s, cc, max_steps, buffer_size),
        ("rosenbrock", int(max_steps), int(buffer_size)), fn, args, st, c)
    n_acc, n_step = torch.stack([st.n_acc, st.n_step]).tolist()
    return _finish(ts, y0, st.t, st.y, n_acc, n_step, c, return_stats,
                   st[7:])


def _rosenbrock_stepwise(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args=None,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 4096,
    breakpoints: torch.Tensor | None = None,
    dt_max: float | None = None,
    return_stats: bool = False,
):
    """``odeint_rosenbrock`` with one host read per step: the plain
    reference the blocked loop is held against (tests and chip_smoke.py
    only)."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    ts = ts.to(y0.dtype)
    c, st = _setup(rhs, y0, ts, rtol, atol, buffer_size, breakpoints, dt_max)
    t, y, f, h = st[:4]
    n_acc = n_step = 0
    recs = ([], [], [])
    while True:
        y1, f1, h_eff, accept, t_new, h_new, dead = _attempt(rhs, t, y, f,
                                                             h, c)
        accept, dead, done = torch.stack([accept, dead,
                                          t_new >= c.t_end]).tolist()
        if accept:
            for r, x in zip(recs, (t, h_eff, torch.stack([y, f, y1, f1]))):
                r.append(x)
            y, f = y1, f1
            n_acc += 1
        t, h = t_new, h_new
        n_step += 1
        if done or dead or n_step >= max_steps or n_acc >= buffer_size:
            break
    records = tuple(torch.stack(r) for r in recs) if n_acc else (None,) * 3
    return _finish(ts, y0, t, y, n_acc, n_step, c, return_stats, records)
