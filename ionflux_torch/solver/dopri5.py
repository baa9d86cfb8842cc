"""Adaptive Dormand-Prince 5(4) with dense output (counterpart of
``ionflux/solver/dopri5.py::odeint``).

Phase 1 steps adaptively from ts[0] to ts[-1] and keeps each ACCEPTED
step's record (t0, h, y0, K[7, S]).  Phase 2 evaluates Shampine's quartic
interpolant for every output time at once: ``searchsorted`` into the
accepted step starts, gather, one einsum.

The step loop runs in blocks of ``BLOCK_STEPS`` steps with one host read
per block (the stop flag; on the card read while the next block runs).
The state (t, h, y, f, the accepted and attempted step counts, the stop
flag) and the record buffers live on the solve's device; each attempt is
written at slot ``n_acc`` and only an accepted step moves ``n_acc`` past
it, and a solve that has stopped makes its block's later steps change
nothing (``torch.where`` over the values the step computes anyway).  On a
CUDA device a block is captured once as a CUDA graph per (right-hand side,
argument structure and shapes, dtype, settings) and replayed, the solve's
inputs copied into the graph's static buffers; on the CPU it runs eagerly.
``_odeint_stepwise`` keeps the per-step loop with its host read per step as
the plain reference: both loops share ``_attempt``, so they give the same
results bit for bit.  The controller algebra stays in tensors of the
solve's dtype, so an f32 solve follows the reference's f32 trajectory.

Failure never raises: a non-finite state, a step pinned at h_min, or an
exhausted ``max_steps``/``buffer_size`` ends the solve, and every output is
inf.  This is the plain path behind ``eval.simulate``; the fused trip
solves in ``ops/fused_solve.py`` use a different controller.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ionflux_torch.ops._build import Graph

# --- Dormand-Prince 5(4) tableau (Dormand & Prince 1980; Hairer I, Table 5.2)
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, :1] = [1 / 5]
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B_SOL = _A[6]  # 5th-order weights (FSAL: k7 = f(t+h, y1))
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                -92097 / 339200, 187 / 2100, 1 / 40])
_B_ERR = _B_SOL - _B4

# 4th-order dense-output polynomial in theta=(t-t0)/h (Shampine 1986):
# y(t0+theta*h) = y0 + h * sum_i (P @ [th, th^2, th^3, th^4])_i * k_i
_P_DENSE = np.array([
    [1.0, -8048581381 / 2820520608, 8663915743 / 2820520608,
     -12715105075 / 11282082432],
    [0.0, 0.0, 0.0, 0.0],
    [0.0, 131558114200 / 32700410799, -68118460800 / 10900136933,
     87487479700 / 32700410799],
    [0.0, -1754552775 / 470086768, 14199869525 / 1410260304,
     -10690763975 / 1880347072],
    [0.0, 127303824393 / 49829197408, -318862633887 / 49829197408,
     701980252875 / 199316789632],
    [0.0, -282668133 / 205662961, 2019193451 / 616988883,
     -1453857185 / 822651844],
    [0.0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423],
])

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0

# Steps per block of the device-paced loop: one host read per block, and at
# most BLOCK_STEPS - 1 steps computed (and discarded) after the solve stops.
BLOCK_STEPS = 32


class SolveStats(NamedTuple):
    ok: bool          # solve reached t_end with finite state
    n_accepted: int
    n_steps: int


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x)))


def _initial_step(rhs, t0, y0, f0, rtol, atol):
    """Hairer/Norsett/Wanner starting-step heuristic (Hairer I, p. 169)."""
    tiny = torch.full_like(t0, 1e-6)
    scale = atol + torch.abs(y0) * rtol
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, tiny, 0.01 * d0 / torch.clamp(d1, min=1e-30))
    y1 = y0 + h0 * f0
    f1 = rhs(t0 + h0, y1)
    d2 = _rms((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.maximum(tiny, h0 * 1e-3),
                     (0.01 / dmax) ** 0.2)
    h = torch.minimum(100.0 * h0, h1)
    return torch.where(torch.isfinite(h) & (h > 0), h, tiny)


def _rk_step(rhs, t, y, f0, h, tab):
    """One dopri5 step. Returns y1, f1 (FSAL), K [7, S], err [S]."""
    c, a, b_sol, b_err = tab
    k = torch.zeros((7,) + tuple(y.shape), dtype=y.dtype, device=y.device)
    k[0] = f0
    for i in range(1, 7):
        yi = y + h * torch.tensordot(a[i], k, dims=1)
        k[i] = rhs(t + c[i] * h, yi)
    y1 = y + h * torch.tensordot(b_sol, k, dims=1)
    err = h * torch.tensordot(b_err, k, dims=1)
    return y1, k[6], k, err


class _Consts(NamedTuple):
    """A solve's fixed tensors (the tableau, tolerances, t_end, h_min, the
    breakpoints and the error weight) and its host settings."""

    tab: tuple
    rtol: torch.Tensor
    atol: torch.Tensor
    t_end: torch.Tensor
    h_min: torch.Tensor
    bp: torch.Tensor | None
    weight: torch.Tensor | None
    wsum: torch.Tensor | None
    dt_max: float | None


def _consts(ts, rtol, atol, breakpoints, error_weight, dt_max, dtype, dev):
    t0, t_end = ts[0], ts[-1]
    big = torch.finfo(dtype).max
    bp = wsum = None
    if breakpoints is not None:
        bp = torch.cat([breakpoints.to(dtype).reshape(-1),
                        torch.full((1,), big, dtype=dtype, device=dev)])
    if error_weight is not None:
        wsum = torch.clamp(torch.sum(error_weight),
                           min=torch.finfo(dtype).tiny)
    return _Consts(
        tuple(torch.as_tensor(x, dtype=dtype, device=dev)
              for x in (_C, _A, _B_SOL, _B_ERR)),
        torch.tensor(rtol, dtype=dtype, device=dev),
        torch.tensor(atol, dtype=dtype, device=dev),
        t_end, torch.clamp(t_end - t0, min=1.0) * 1e-12, bp, error_weight,
        wsum, dt_max)


def _attempt(rhs, t, y, f, h, c: _Consts):
    """One attempted step from (t, y, f) with the proposed step h.  Returns
    (y1, f1, K, h_eff, accept, finite_ratio, pinned, t_new, h_new); the
    flags are 0-d bool tensors."""
    # clamp the step: never overshoot t_end, never straddle a breakpoint
    h_eff = torch.minimum(h, c.t_end - t)
    if c.bp is not None:
        nxt = torch.take(c.bp, torch.searchsorted(c.bp, t.reshape(1),
                                                  right=True))[0]
        h_eff = torch.minimum(h_eff, nxt - t)
    h_eff = torch.maximum(h_eff, c.h_min)

    y1, f1, k, err = _rk_step(rhs, t, y, f, h_eff, c.tab)
    scale = c.atol + c.rtol * torch.maximum(torch.abs(y), torch.abs(y1))
    if c.weight is None:
        ratio = _rms(err / scale)
    else:
        ratio = torch.sqrt(
            torch.sum(c.weight * torch.square(err / scale)) / c.wsum)
    ratio_ok = torch.isfinite(ratio)
    accept = (ratio <= 1.0) & torch.all(torch.isfinite(y1)) & ratio_ok

    factor = SAFETY * torch.pow(torch.clamp(ratio, min=1e-10), -0.2)
    factor = torch.where(torch.isfinite(factor), factor,
                         torch.full_like(factor, MIN_FACTOR))
    max_up = torch.where(accept, torch.full_like(factor, MAX_FACTOR),
                         torch.ones_like(factor))
    h_new = h_eff * torch.minimum(torch.clamp(factor, min=MIN_FACTOR),
                                  max_up)
    if c.dt_max is not None:
        h_new = torch.clamp(h_new, max=c.dt_max)
    t_new = torch.where(accept, t + h_eff, t)
    return (y1, f1, k, h_eff, accept, ratio_ok, h_eff <= c.h_min * 2, t_new,
            h_new)


def _start(rhs, t0, y0, c: _Consts):
    """The first right-hand side and the starting step."""
    f = rhs(t0, y0)
    h = _initial_step(rhs, t0, y0, f, c.rtol, c.atol)
    if c.dt_max is not None:
        h = torch.clamp(h, max=c.dt_max)
    return f, h


def _dense(ts, y0, rec_t, rec_h, rec_y, rec_k, n_acc: int, ok: bool):
    """Phase 2: ys [T, S] from the first n_acc records (inf unless ok)."""
    dtype, dev = y0.dtype, y0.device
    if not ok:
        return torch.full((ts.shape[0],) + tuple(y0.shape), float("inf"),
                          dtype=dtype, device=dev)
    p_dense = torch.as_tensor(_P_DENSE, dtype=dtype, device=dev)
    bt, bh, by, bk = rec_t[:n_acc], rec_h[:n_acc], rec_y[:n_acc], rec_k[:n_acc]
    idx = torch.clamp(torch.searchsorted(bt, ts, right=True) - 1,
                      0, n_acc - 1)
    th = torch.clamp((ts - bt[idx]) / bh[idx], 0.0, 1.0)
    tp = torch.stack([th, th ** 2, th ** 3, th ** 4], dim=-1)   # [T, 4]
    bpoly = tp @ p_dense.T                                       # [T, 7]
    ys = by[idx] + bh[idx][:, None] * torch.einsum(
        "tj,tjs->ts", bpoly, bk[idx])
    ys[0] = y0
    return ys


class _State(NamedTuple):
    """A solve's state and record buffers on its device.  The records hold
    buffer_size + 1 slots: the attempt of a solve that stopped on a full
    buffer is written at slot buffer_size and never read."""

    t: torch.Tensor        # 0-d
    h: torch.Tensor        # 0-d
    y: torch.Tensor        # [S]
    f: torch.Tensor        # [S]
    n_acc: torch.Tensor    # 0-d int64
    n_step: torch.Tensor   # 0-d int64
    stop: torch.Tensor     # 0-d bool
    rec_t: torch.Tensor    # [buffer_size + 1]
    rec_h: torch.Tensor    # [buffer_size + 1]
    rec_y: torch.Tensor    # [buffer_size + 1, S]
    rec_k: torch.Tensor    # [buffer_size + 1, 7, S]


def _new_state(t0, h, y0, f, buffer_size: int) -> _State:
    dtype, dev = y0.dtype, y0.device
    n = buffer_size + 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return _State(t0.clone(), h.clone(), y0.clone(), f.clone(), zero,
                  zero.clone(), torch.zeros((), dtype=torch.bool, device=dev),
                  torch.zeros(n, dtype=dtype, device=dev),
                  torch.zeros(n, dtype=dtype, device=dev),
                  torch.zeros((n,) + tuple(y0.shape), dtype=dtype, device=dev),
                  torch.zeros((n, 7) + tuple(y0.shape), dtype=dtype,
                              device=dev))


def _block(rhs, st: _State, c: _Consts, max_steps: int,
           buffer_size: int) -> None:
    """BLOCK_STEPS steps of the solve in st, updated in place; no host
    read.  A stopped solve's steps change nothing."""
    t, h, y, f, n_acc, n_step, stop = st[:7]
    for _ in range(BLOCK_STEPS):
        y1, f1, k, h_eff, accept, ratio_ok, pinned, t_new, h_new = _attempt(
            rhs, t, y, f, h, c)
        slot = n_acc.reshape(1)
        st.rec_t.index_copy_(0, slot, t.reshape(1))
        st.rec_h.index_copy_(0, slot, h_eff.reshape(1))
        st.rec_y.index_copy_(0, slot, y[None])
        st.rec_k.index_copy_(0, slot, k[None])
        live = ~stop
        take = accept & live
        y = torch.where(take, y1, y)
        f = torch.where(take, f1, f)
        n_acc = n_acc + take.to(torch.int64)
        t = torch.where(live, t_new, t)
        h = torch.where(live, h_new, h)
        n_step = n_step + live.to(torch.int64)
        dead = ((~ratio_ok & pinned) | (n_step >= max_steps)
                | (n_acc >= buffer_size))
        stop = stop | (live & ((t_new >= c.t_end) | dead))
    for dst, src in zip(st[:7], (t, h, y, f, n_acc, n_step, stop)):
        dst.copy_(src)


# ---------------------------------------------------------------------------
# The block as a CUDA graph
# ---------------------------------------------------------------------------


def _structure(x, leaves: list):
    """A hashable key of x's structure and host values; x's tensors (an
    nn.Module's parameters and buffers included) are appended to leaves in
    a fixed order.  Host values (the models' scalar parameters) are
    constants of a captured graph, so they belong to its key."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, nn.Module):
        ts = list(x.parameters()) + list(x.buffers())
        leaves.extend(ts)
        return (type(x), tuple((tuple(p.shape), p.dtype) for p in ts))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_structure(v, leaves) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _structure(x[k], leaves)) for k in sorted(x)))
    hash(x)
    return ("value", x)


def _clone(x):
    """x with every tensor cloned and every nn.Module deep-copied."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, nn.Module):
        return copy.deepcopy(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_clone(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _fn_key(fn):
    """fn's code and closure values: right-hand sides made afresh per call
    (``eval._model_rhs``) share a graph.  A closure over a tensor cannot be
    captured safely (the graph would keep reading that tensor)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn
    cells = tuple(cell.cell_contents for cell in (fn.__closure__ or ()))
    if any(isinstance(x, (torch.Tensor, nn.Module)) for x in cells):
        raise ValueError("odeint on a CUDA device: the right-hand side "
                         "closes over a tensor; pass it in args so the "
                         "block's CUDA graph reads a copy of it")
    return (code, cells)


class _BlockGraph:
    """One solve setting's block, captured as a CUDA graph on static copies
    of the state, the constants and the right-hand side's arguments.
    ``block(rhs, st, c)`` advances the state ``st`` (a NamedTuple of
    tensors) in place."""

    def __init__(self, block, fn, args, st, c):
        self.args = _clone(args)
        self.st = type(st)(*[x.clone() for x in st])
        self.c = _clone(c)
        self.leaves = []
        _structure((self.st, self.c, self.args), self.leaves)
        rhs = lambda t, y: fn(t, y, self.args)  # noqa: E731

        def run(*_):
            block(rhs, self.st, self.c)

        try:
            self.graph = Graph(run)
        except RuntimeError as exc:
            raise RuntimeError(
                "odeint: capturing the step block as a CUDA graph failed; "
                "the right-hand side must make no host read or host-to-"
                f"device copy ({exc})") from exc

    def load(self, st, c, args):
        """Copy a solve's state, constants and arguments into the static
        buffers; returns the static state the replays advance."""
        leaves = []
        _structure((st, c, args), leaves)
        with torch.no_grad():
            for dst, src in zip(self.leaves, leaves):
                dst.copy_(src)
        return self.st


# Captured blocks by (fn, argument structure, shapes, dtype, settings)
_GRAPHS: dict = {}


def _run_blocks(block, settings: tuple, fn, args, st, c):
    """Advance st block by block until it stops (``st.stop``), one host read
    per block; ``block(rhs, st, c)`` runs one block in place and
    ``settings`` are its host settings.  On a CUDA device the blocks replay
    a captured graph (the first solve of a setting runs its first block
    eagerly, then captures), one block queued ahead of the flag the host
    reads; on the CPU they run eagerly.  Returns the state holding the
    result."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    if st.y.device.type != "cuda":
        while True:
            block(rhs, st, c)
            if bool(st.stop):
                return st
    leaves = []
    key = (_fn_key(fn), _structure((st, c, args), leaves), str(st.y.device),
           settings, BLOCK_STEPS)
    g = _GRAPHS.get(key)
    if g is None:
        block(rhs, st, c)
        if bool(st.stop):
            return st
        g = _GRAPHS[key] = _BlockGraph(block, fn, args, st, c)
    st = g.load(st, c, args)
    # each block's stop flag goes to pinned host memory as the next block is
    # queued, so the host's launch of a block overlaps the run of the one
    # before; the block queued after the stop changes nothing
    flags = [torch.zeros((), dtype=torch.bool).pin_memory() for _ in range(2)]
    ready = [torch.cuda.Event(), torch.cuda.Event()]
    g.graph.replay()
    flags[0].copy_(st.stop, non_blocking=True)
    ready[0].record()
    i = 0
    while True:
        g.graph.replay()
        flags[1 - i].copy_(st.stop, non_blocking=True)
        ready[1 - i].record()
        ready[i].synchronize()
        if bool(flags[i]):
            return st
        i = 1 - i


def odeint(
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
    error_weight: torch.Tensor | None = None,
):
    """Integrate dy/dt = fn(t, y, args) from ts[0], returning y at all ``ts``.

    fn: (t, y[S], args) -> dy[S].  ts: ascending [T].  Returns ys [T, S]
    (and SolveStats if return_stats).  ``breakpoints`` clamp steps so none
    straddles a discontinuity; ``error_weight`` [S] makes the step control
    a seminorm sqrt(sum(w*(err/scale)^2)/sum(w)).  On a CUDA device fn must
    be capturable: no host read, no host-to-device copy, no tensor in its
    closure (the port's right-hand sides are)."""
    dtype, dev = y0.dtype, y0.device
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    ts = ts.to(dtype)
    c = _consts(ts, rtol, atol, breakpoints, error_weight, dt_max, dtype, dev)
    f, h = _start(rhs, ts[0], y0, c)
    st = _run_blocks(
        lambda r, s, cc: _block(r, s, cc, max_steps, buffer_size),
        ("odeint", int(max_steps), int(buffer_size)), fn, args,
        _new_state(ts[0], h, y0, f, buffer_size), c)
    n_acc, n_step, done, finite = torch.stack([
        st.n_acc, st.n_step, (st.t >= c.t_end).to(torch.int64),
        torch.all(torch.isfinite(st.y)).to(torch.int64)]).tolist()
    ok = bool(done) and bool(finite) and n_acc > 0
    ys = _dense(ts, y0, st.rec_t, st.rec_h, st.rec_y, st.rec_k, n_acc, ok)
    if return_stats:
        return ys, SolveStats(ok=ok, n_accepted=n_acc, n_steps=n_step)
    return ys


def _odeint_stepwise(
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
    error_weight: torch.Tensor | None = None,
):
    """``odeint`` with one host read per step: the plain reference the
    blocked loop is held against (tests and chip_smoke.py only)."""
    dtype, dev = y0.dtype, y0.device
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    ts = ts.to(dtype)
    c = _consts(ts, rtol, atol, breakpoints, error_weight, dt_max, dtype, dev)
    f, h = _start(rhs, ts[0], y0, c)
    t, y = ts[0], y0
    n_acc = n_step = 0
    rec_t, rec_h, rec_y, rec_k = [], [], [], []
    while True:
        y1, f1, k, h_eff, accept_t, ratio_ok, pinned_t, t_new, h_new = \
            _attempt(rhs, t, y, f, h, c)
        accept, finite_ratio, pinned, done = torch.stack([
            accept_t, ratio_ok, pinned_t, t_new >= c.t_end]).tolist()
        if accept:
            rec_t.append(t)
            rec_h.append(h_eff)
            rec_y.append(y)
            rec_k.append(k)
            y, f = y1, f1
            n_acc += 1
        t, h = t_new, h_new
        n_step += 1
        dead = ((not finite_ratio and pinned) or n_step >= max_steps
                or n_acc >= buffer_size)
        if done or dead:
            break

    ok = (bool(t >= c.t_end) and bool(torch.all(torch.isfinite(y)))
          and n_acc > 0)
    if ok:
        ys = _dense(ts, y0, torch.stack(rec_t), torch.stack(rec_h),
                    torch.stack(rec_y), torch.stack(rec_k), n_acc, ok)
    else:
        ys = _dense(ts, y0, None, None, None, None, n_acc, ok)
    if return_stats:
        return ys, SolveStats(ok=ok, n_accepted=n_acc, n_steps=n_step)
    return ys
