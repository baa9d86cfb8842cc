"""Adaptive Adams-Bashforth-Moulton (PECE) integrator, fixed order 4
(counterpart of ``ionflux/solver/adams.py::odeint_adams``).

The 4-deep uniform derivative history is (re)built by error-controlled RK4
starter steps (step-doubling estimate) whenever the step size changes or
near t_end; warm steps use the Milne device |corrector - predictor| *
19/270.  Dense output is per-step cubic Hermite, evaluated for every output
time at once in a second phase (as ``dopri5``'s).

The step loop is device-paced like ``odeint``'s (``dopri5._run_blocks``):
blocks of ``BLOCK_STEPS`` attempts, one host read per block, each block a
replayed CUDA graph on the card.  A captured block cannot branch on the
host, so every attempt computes both the warm step (2 right-hand sides)
and the cold starter step (14) and keeps one with ``torch.where`` (the
reference picks one with ``lax.cond``): the same numbers for 16
right-hand-side evaluations an attempt.  ``_adams_stepwise`` keeps a
per-step loop with a host read per step as the reference; both loops share
``_attempt`` and give the same results bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ionflux_torch.solver.dopri5 import (BLOCK_STEPS, SolveStats, _rms,
                                         _run_blocks)

_AB_NP = np.array([55.0, -59.0, 37.0, -9.0]) / 24.0
_AM_NP = np.array([9.0, 19.0, -5.0, 1.0]) / 24.0
_MILNE = 19.0 / 270.0


def _rk4(rhs, t, y, h):
    k1 = rhs(t, y)
    k2 = rhs(t + 0.5 * h, y + 0.5 * h * k1)
    k3 = rhs(t + 0.5 * h, y + 0.5 * h * k2)
    k4 = rhs(t + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


class _Consts(NamedTuple):
    ab: torch.Tensor      # [4] Adams-Bashforth weights
    am: torch.Tensor      # [4] Adams-Moulton weights
    t_end: torch.Tensor   # 0-d
    h_min: torch.Tensor   # 0-d
    rtol: float
    atol: float


class _State(NamedTuple):
    """The solve's state and its records on the device (``buffer_size + 1``
    slots; the attempt of a stopped solve lands past the accepted ones)."""

    t: torch.Tensor        # 0-d
    y: torch.Tensor        # [S]
    h: torch.Tensor        # 0-d
    hist: torch.Tensor     # [4, S] derivative history, newest first
    n_hist: torch.Tensor   # 0-d int64
    n_acc: torch.Tensor    # 0-d int64
    n_step: torch.Tensor   # 0-d int64
    stop: torch.Tensor     # 0-d bool
    rec_t: torch.Tensor    # [buffer_size + 1]
    rec_h: torch.Tensor    # [buffer_size + 1]
    rec_y: torch.Tensor    # [buffer_size + 1, S]
    rec_c: torch.Tensor    # [buffer_size + 1, 3, S] theta..theta^3 terms


def _setup(rhs, y0, ts, rtol, atol, buffer_size):
    """(consts, initial state) of a solve."""
    dtype, dev = y0.dtype, y0.device
    t0, t_end = ts[0], ts[-1]
    s = y0.shape[0]
    c = _Consts(torch.as_tensor(_AB_NP, dtype=dtype, device=dev),
                torch.as_tensor(_AM_NP, dtype=dtype, device=dev),
                t_end, torch.tensor(1e-10, dtype=dtype, device=dev),
                float(rtol), float(atol))
    f00 = rhs(t0, y0)
    scale0 = atol + rtol * torch.abs(y0)
    d1 = torch.sqrt(torch.mean((f00 / scale0) ** 2))
    h0 = torch.minimum(torch.clamp(0.01 / torch.clamp(d1, min=1e-10),
                                   min=1e-6), (t_end - t0) / 16.0)
    n = buffer_size + 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = _State(t0.clone(), y0.clone(), h0,
                torch.zeros((4, s), dtype=dtype, device=dev), zero,
                zero.clone(), zero.clone(),
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros(n, dtype=dtype, device=dev),
                torch.ones(n, dtype=dtype, device=dev),
                torch.zeros((n, s), dtype=dtype, device=dev),
                torch.zeros((n, 3, s), dtype=dtype, device=dev))
    return c, st


def _attempt(rhs, t, y, h, hist, n_hist, c: _Consts):
    """One attempt from (t, y) with step h: the warm ABM4 step and the cold
    RK4 starter step both computed, one kept.  Returns (accept, y_new,
    f_start, f_end, h_used, h_new, hist_new, n_hist_new)."""
    remaining = c.t_end - t
    warm = (n_hist >= 4) & (remaining > 4.0 * h)

    # warm: predictor, one evaluation, corrector, one more (PECE)
    y_p = y + h * torch.tensordot(c.ab, hist, dims=1)
    f_p = rhs(t + h, y_p)
    fc = torch.cat([f_p[None], hist[:3]])
    y_c = y + h * torch.tensordot(c.am, fc, dims=1)
    err = _MILNE * torch.abs(y_c - y_p)
    scale = c.atol + c.rtol * torch.maximum(torch.abs(y), torch.abs(y_c))
    ratio = _rms(err / scale)
    finite = torch.all(torch.isfinite(y_c)) & torch.isfinite(ratio)
    acc_w = (ratio <= 1.0) & finite
    f_c = rhs(t + h, y_c)
    grow = acc_w & (ratio < 0.05)
    h_new_w = torch.where(~acc_w, h * 0.5, torch.where(grow, h * 2.0, h))
    n_hist_w = torch.where(acc_w & ~grow, 4, 0)
    hist_w = torch.where(acc_w, torch.cat([f_c[None], hist[:3]]), hist)

    # cold: error-controlled RK4 starter (step-doubling estimate)
    h_eff = torch.minimum(h, remaining)
    clamped = h_eff < h * 0.999
    f_t = rhs(t, y)
    y_full = _rk4(rhs, t, y, h_eff)
    y_half = _rk4(rhs, t + 0.5 * h_eff, _rk4(rhs, t, y, 0.5 * h_eff),
                  0.5 * h_eff)
    err = torch.abs(y_full - y_half) * (16.0 / 15.0)
    scale = c.atol + c.rtol * torch.maximum(torch.abs(y), torch.abs(y_half))
    ratio = _rms(err / scale)
    finite = torch.all(torch.isfinite(y_half)) & torch.isfinite(ratio)
    acc_c = (ratio <= 1.0) & finite
    f_new = rhs(t + h_eff, y_half)
    h_new_c = torch.where(~acc_c, h * 0.5, h)
    # a clamped (shortened) step breaks uniform spacing
    n_hist_c = torch.where(acc_c & ~clamped,
                           torch.clamp(n_hist + 1, max=4), 0)
    hist_c = torch.where(acc_c, torch.cat([f_new[None], hist[:3]]), hist)

    def pick(a, b):
        return torch.where(warm, a, b)

    return (pick(acc_w, acc_c), pick(y_c, y_half), pick(hist[0], f_t),
            pick(f_c, f_new), pick(h, h_eff), pick(h_new_w, h_new_c),
            pick(hist_w, hist_c), pick(n_hist_w, n_hist_c))


def _coef(y_start, y_end, f_start, f_end, h):
    """The step's cubic Hermite terms in theta, theta^2, theta^3."""
    delta = (y_end - y_start) / h
    return torch.stack([f_start, 3 * delta - 2 * f_start - f_end,
                        f_start + f_end - 2 * delta])


def _advance(t, y, h, hist, n_hist, n_acc, n_step, out, c: _Consts,
             max_steps: int, buffer_size: int):
    """The state after an attempt's outputs: (t, y, h, hist, n_hist, n_acc,
    n_step, go on) as the reference's loop body forms them."""
    accept, y_new_c, _, _, h_used, h_new, hist_new, n_hist_new = out
    t_new = torch.where(accept, t + h_used, t)
    y_new = torch.where(accept, y_new_c, y)
    hist = torch.where(accept, hist_new, hist)
    n_hist = torch.where(accept, n_hist_new, 0)
    n_acc = n_acc + accept.to(torch.int64)
    n_step = n_step + 1
    h_new = torch.maximum(h_new, c.h_min)
    dead = ((n_step >= max_steps) | (n_acc >= buffer_size - 1)
            | (h_new <= c.h_min * 2))
    go = ~dead & (t_new < c.t_end - 1e-9 * torch.abs(c.t_end))
    return t_new, y_new, h_new, hist, n_hist, n_acc, n_step, go


def _block(rhs, st: _State, c: _Consts, max_steps: int,
           buffer_size: int) -> None:
    """BLOCK_STEPS attempts of the solve in st, updated in place; no host
    read.  A stopped solve's attempts change nothing."""
    t, y, h, hist, n_hist, n_acc, n_step, stop = st[:8]
    for _ in range(BLOCK_STEPS):
        out = _attempt(rhs, t, y, h, hist, n_hist, c)
        slot = n_acc.reshape(1)
        st.rec_t.index_copy_(0, slot, t.reshape(1))
        st.rec_h.index_copy_(0, slot, out[4].reshape(1))
        st.rec_y.index_copy_(0, slot, y[None])
        st.rec_c.index_copy_(0, slot, _coef(y, out[1], out[2], out[3],
                                            out[4])[None])
        new = _advance(t, y, h, hist, n_hist, n_acc, n_step, out, c,
                       max_steps, buffer_size)
        live = ~stop
        t, y, h, hist, n_hist, n_acc, n_step = (
            torch.where(live, a, b) for a, b in zip(
                new[:7], (t, y, h, hist, n_hist, n_acc, n_step)))
        stop = stop | (live & ~new[7])
    for dst, src in zip(st[:8], (t, y, h, hist, n_hist, n_acc, n_step, stop)):
        dst.copy_(src)


def _dense(ts, y0, rec_t, rec_h, rec_y, rec_c, n_acc: int, ok: bool):
    """Phase 2: ys [T, S] from the first n_acc records (inf unless ok)."""
    if not ok:
        return torch.full((ts.shape[0],) + tuple(y0.shape), float("inf"),
                          dtype=y0.dtype, device=y0.device)
    bt, bh = rec_t[:n_acc], rec_h[:n_acc]
    idx = torch.clamp(torch.searchsorted(bt, ts, right=True) - 1, 0,
                      n_acc - 1)
    th = torch.clamp((ts - bt[idx]) / bh[idx], 0.0, 1.0)
    tp = torch.stack([th, th ** 2, th ** 3], dim=-1)
    ys = rec_y[idx] + bh[idx][:, None] * torch.einsum("tj,tjs->ts", tp,
                                                      rec_c[idx])
    ys[0] = y0
    return ys


def _finish(ts, y0, t, y, n_acc: int, n_step: int, c: _Consts,
            return_stats: bool, records):
    ok = (bool(t >= c.t_end - 1e-6) and bool(torch.all(torch.isfinite(y)))
          and n_acc > 0)
    ys = _dense(ts, y0, *records, n_acc, ok)
    if return_stats:
        return ys, SolveStats(ok=ok, n_accepted=n_acc, n_steps=n_step)
    return ys


def odeint_adams(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args=None,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 8192,
    return_stats: bool = False,
):
    """Integrate dy/dt = fn(t, y, args); returns y at ``ts`` like odeint
    (all inf where the solve fails).  On a CUDA device fn must be
    capturable, as ``odeint``'s."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    ts = ts.to(y0.dtype)
    c, st = _setup(rhs, y0, ts, rtol, atol, buffer_size)
    st = _run_blocks(
        lambda r, s, cc: _block(r, s, cc, max_steps, buffer_size),
        ("adams", int(max_steps), int(buffer_size)), fn, args, st, c)
    n_acc, n_step = torch.stack([st.n_acc, st.n_step]).tolist()
    return _finish(ts, y0, st.t, st.y, n_acc, n_step, c, return_stats,
                   st[8:])


def _adams_stepwise(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args=None,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 8192,
    return_stats: bool = False,
):
    """``odeint_adams`` with one host read per step: the plain reference
    the blocked loop is held against (tests and chip_smoke.py only)."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    ts = ts.to(y0.dtype)
    c, st = _setup(rhs, y0, ts, rtol, atol, buffer_size)
    t, y, h, hist, n_hist, n_acc, n_step = st[:7]
    recs = ([], [], [], [])
    while True:
        out = _attempt(rhs, t, y, h, hist, n_hist, c)
        if bool(out[0]):
            for r, x in zip(recs, (t, out[4], y, _coef(y, out[1], out[2],
                                                       out[3], out[4]))):
                r.append(x)
        t, y, h, hist, n_hist, n_acc, n_step, go = _advance(
            t, y, h, hist, n_hist, n_acc, n_step, out, c, max_steps,
            buffer_size)
        if not bool(go):
            break
    n = int(n_acc)
    records = tuple(torch.stack(r) for r in recs) if n else (None,) * 4
    return _finish(ts, y0, t, y, n, int(n_step), c, return_stats, records)
