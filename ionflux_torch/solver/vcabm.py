"""Variable-coefficient, variable-order Adams-Bashforth-Moulton (VCABM),
orders 1-12 (counterpart of ``ionflux/solver/vcabm.py::odeint_vcabm``).

The method in Newton divided-difference form with exact Gauss-Legendre
quadrature of the interpolating polynomial:

  predictor  p    = y_n + sum_{j<k}   I_j  * dd_j      (explicit, order k)
  corrector  y_c  = y_n + sum_{j<=k}  I2_j * dd2_j     (implicit, order k+1)

dd_j are the divided differences over the 13-deep history ring (dd2 over
the set extended with (t_{n+1}, f(t_{n+1}, p))), I_j the integrals over
[t_n, t_{n+1}] of the Newton basis, exact with 7-point Gauss-Legendre.
Every table has a fixed shape ([13] / [13, S]) with order and history
masks, so a step is straight-line tensor code.  The error estimate is the
highest included term; the order moves by comparing the neighbouring
orders' terms after each step; the method starts at k = 1.  Dense output
integrates each accepted step's corrector polynomial to the output times
with the same quadrature, in a second phase.

The step loop is device-paced like ``odeint``'s (``dopri5._run_blocks``):
blocks of ``BLOCK_STEPS`` attempts, one host read per block, each block a
replayed CUDA graph on the card.  ``_vcabm_stepwise`` keeps the per-step
loop as the reference; both share ``_attempt`` and agree bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ionflux_torch.solver.dopri5 import (BLOCK_STEPS, SolveStats,
                                         _initial_step, _run_blocks)

H = 13          # history depth: supports corrector orders up to 13 (k<=12)
K_MAX = 12      # max predictor order

# 7-point Gauss-Legendre on [-1, 1], exact for degree <= 13
_GL_X = np.array([
    0.0,
    -0.4058451513773972, 0.4058451513773972,
    -0.7415311855993945, 0.7415311855993945,
    -0.9491079123427585, 0.9491079123427585,
])
_GL_W = np.array([
    0.4179591836734694,
    0.3818300505051189, 0.3818300505051189,
    0.2797053914892766, 0.2797053914892766,
    0.1294849661688697, 0.1294849661688697,
])


def _divided_diffs(tvec, fvec, n_valid):
    """Top-row Newton divided differences over (tvec, fvec) [H], [H, S]:
    dd [H, S] with dd[j] = f[t_0, ..., t_j] for j < n_valid and 0 beyond.
    Entries of tvec past n_valid may hold any padding (their denominators
    are masked)."""
    h = tvec.shape[0]
    pos = torch.arange(h, device=tvec.device)
    t_pad = torch.cat([tvec, torch.zeros_like(tvec)])
    zero_row = torch.zeros_like(fvec[:1])
    col = torch.where((pos < n_valid)[:, None], fvec, 0.0)
    dd = [fvec[0]]
    for j in range(1, h):
        # col_j[i] = (col_{j-1}[i] - col_{j-1}[i+1]) / (t_i - t_{i+j})
        c_sh = torch.cat([col[1:], zero_row])
        valid = (pos + j) < n_valid
        den = torch.where(valid, tvec - t_pad[j:j + h], 1.0)
        col = torch.where(valid[:, None], (col - c_sh) / den[:, None], 0.0)
        dd.append(col[0])
    return torch.stack(dd)


def _newton_integrals(t_from, t_to, tvec, glx, glw):
    """I_j = integral_{t_from}^{t_to} prod_{i<j} (t - tvec[i]) dt,
    j = 0..H-1, by 7-point Gauss-Legendre."""
    half = (t_to - t_from) * 0.5
    tau = t_from + half * (glx + 1.0)                     # [7]
    diff = tau[:, None] - tvec[None, :]                   # [7, H]
    basis = torch.cumprod(
        torch.cat([torch.ones_like(diff[:, :1]), diff[:, :H - 1]], dim=1),
        dim=1)                                            # [7, H]
    return half * torch.einsum("q,qj->j", glw, basis)


class _Consts(NamedTuple):
    glx: torch.Tensor
    glw: torch.Tensor
    jr: torch.Tensor       # arange(H)
    rtol: torch.Tensor
    atol: torch.Tensor
    t_end: torch.Tensor
    h_min: torch.Tensor


class _State(NamedTuple):
    """The solve's state and its records on the device (``buffer_size + 1``
    slots)."""

    t: torch.Tensor         # 0-d
    y: torch.Tensor         # [S]
    h: torch.Tensor         # 0-d
    k: torch.Tensor         # 0-d int64, the order
    ts_h: torch.Tensor      # [H] history times, newest first
    fs_h: torch.Tensor      # [H, S] history derivatives
    n_hist: torch.Tensor    # 0-d int64
    n_acc: torch.Tensor     # 0-d int64
    n_step: torch.Tensor    # 0-d int64
    stop: torch.Tensor      # 0-d bool
    rec_t: torch.Tensor     # [buffer_size + 1]
    rec_h: torch.Tensor     # [buffer_size + 1]
    rec_y: torch.Tensor     # [buffer_size + 1, S]
    rec_n: torch.Tensor     # [buffer_size + 1, H] corrector nodes (in h)
    rec_d: torch.Tensor     # [buffer_size + 1, H, S] masked dd2


def _setup(rhs, y0, ts, rtol, atol, buffer_size):
    dtype, dev = y0.dtype, y0.device
    t0, t_end = ts[0], ts[-1]
    s = y0.shape[0]
    c = _Consts(torch.as_tensor(_GL_X, dtype=dtype, device=dev),
                torch.as_tensor(_GL_W, dtype=dtype, device=dev),
                torch.arange(H, device=dev),
                torch.tensor(rtol, dtype=dtype, device=dev),
                torch.tensor(atol, dtype=dtype, device=dev), t_end,
                torch.clamp(t_end - t0, min=1.0) * 1e-12)
    f0 = rhs(t0, y0)
    h0 = torch.minimum(
        torch.maximum(_initial_step(rhs, t0, y0, f0, c.rtol, c.atol),
                      c.h_min * 1e3), (t_end - t0) / 16.0)
    ts_h0 = t0 - torch.arange(H, dtype=dtype, device=dev)  # distinct padding
    ts_h0[0] = t0
    fs_h0 = torch.zeros((H, s), dtype=dtype, device=dev)
    fs_h0[0] = f0
    n = buffer_size + 1
    one = torch.ones((), dtype=torch.int64, device=dev)
    st = _State(t0.clone(), y0.clone(), h0, one, ts_h0, fs_h0, one.clone(),
                one - 1, one - 1,
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.full((n,), torch.finfo(dtype).max, dtype=dtype,
                           device=dev),
                torch.ones(n, dtype=dtype, device=dev),
                torch.zeros((n, s), dtype=dtype, device=dev),
                torch.zeros((n, H), dtype=dtype, device=dev),
                torch.zeros((n, H, s), dtype=dtype, device=dev))
    return c, st


def _attempt(rhs, t, y, h, k, ts_h, fs_h, n_hist, c: _Consts):
    """One attempt.  Returns (accept, t1, y_c, h_used, k_new, h_new,
    ts_h_new, fs_h_new, nodes, dd2 masked)."""
    h = torch.minimum(h, c.t_end - t)
    t1 = t + h
    one = torch.ones_like(t)
    zero = torch.zeros_like(t)

    # abscissae in units of h relative to t: intermediates stay O(1)
    th_rel = (ts_h - t) / h
    # cap the usable history to entries within 40 h (stale history after
    # rejections would overflow the Newton products)
    within = torch.abs(th_rel) <= 40.0
    n_eff = torch.sum(torch.cumprod(within.to(torch.int64), dim=0))
    n_use = torch.clamp(torch.minimum(n_hist, n_eff), min=1)
    k = torch.minimum(torch.clamp(k, min=1), n_use)

    # predictor: order k over the history set
    ddp = _divided_diffs(th_rel, fs_h, n_use)
    ip = _newton_integrals(zero, one, th_rel, c.glx, c.glw)
    # masked by selection, not by a 0/1 product: far padded nodes can
    # overflow an unused integral to inf (XLA rewrites the reference's
    # product into a select)
    y_p = y + h * torch.einsum("j,js->s", torch.where(c.jr < k, ip, 0.0),
                               ddp)
    f_p = rhs(t1, y_p)

    # corrector: order k+1 over the set extended with (t1, f_p)
    ts2 = torch.cat([one[None], th_rel[:H - 1]])
    fs2 = torch.cat([f_p[None], fs_h[:H - 1]])
    n2 = torch.clamp(n_use, max=H - 1) + 1
    dd2 = _divided_diffs(ts2, fs2, n2)
    i2 = _newton_integrals(zero, one, ts2, c.glx, c.glw)
    cmask = c.jr <= k
    y_c = y + h * torch.einsum("j,js->s", torch.where(cmask, i2, 0.0), dd2)

    # Milne-style error terms E_j = ||h I2_j dd2_j / scale||
    scale = c.atol + c.rtol * torch.maximum(torch.abs(y), torch.abs(y_c))
    terms = h * i2[:, None] * dd2
    e = torch.sqrt(torch.mean((terms / scale[None]) ** 2, dim=-1))  # [H]
    err = torch.take(e, k)   # e[k], read on the device
    finite = torch.all(torch.isfinite(y_c)) & torch.isfinite(err)
    accept = (err <= 1.0) & finite

    # order adaptation (comparison of adjacent orders)
    inf = torch.full_like(err, float("inf"))
    e_km1 = torch.where(k > 1, torch.take(e, torch.clamp(k - 1, min=0)), inf)
    can_raise = (k < K_MAX) & (n2 > k + 1)
    e_kp1 = torch.where(can_raise,
                        torch.take(e, torch.clamp(k + 1, max=H - 1)), inf)
    k_up = accept & (e_kp1 < err) & (err <= e_km1)
    k_down = e_km1 < torch.minimum(err, e_kp1)
    k_acc = torch.clamp(k + k_up.to(torch.int64) - k_down.to(torch.int64),
                        1, K_MAX)
    # self-start ramp: grow the order while the history allows
    k_acc = torch.where(n_use <= k, torch.clamp(k + 1, max=K_MAX), k_acc)
    k_new = torch.where(accept, k_acc, torch.clamp(k - 1, min=1))

    # step-size controller on the order-(k+1) error
    expo = 1.0 / (k.to(y.dtype) + 1.0)
    factor = torch.where(err > 0, 0.9 * torch.pow(err, -expo),
                         torch.full_like(err, 5.0))
    factor = torch.clamp(factor, 0.2, 5.0)
    h_new = torch.where(accept, h * factor,
                        h * torch.clamp(factor, max=0.5))
    h_new = torch.where(finite, h_new, h * 0.1)
    h_new = torch.maximum(h_new, c.h_min)

    # history push (PECE: final evaluation at the corrected state)
    f_c = rhs(t1, y_c)
    ts_h_new = torch.cat([t1[None], ts_h[:H - 1]])
    fs_h_new = torch.cat([f_c[None], fs_h[:H - 1]])
    return (accept, t1, y_c, h, k_new, h_new, ts_h_new, fs_h_new, ts2,
            torch.where(cmask[:, None], dd2, 0.0))


def _advance(t, y, ts_h, fs_h, n_hist, n_acc, n_step, out, c: _Consts,
             max_steps: int, buffer_size: int):
    """(t, y, h, k, ts_h, fs_h, n_hist, n_acc, n_step, go on) after an
    attempt, as the reference's loop body forms them."""
    accept, t1, y_c, _, k_new, h_new, ts_h_new, fs_h_new = out[:8]
    t_out = torch.where(accept, t1, t)
    y_out = torch.where(accept, y_c, y)
    ts_h = torch.where(accept, ts_h_new, ts_h)
    fs_h = torch.where(accept, fs_h_new, fs_h)
    n_hist = torch.where(accept, torch.clamp(n_hist + 1, max=H), n_hist)
    n_acc = n_acc + accept.to(torch.int64)
    n_step = n_step + 1
    dead = ((n_step >= max_steps) | (n_acc >= buffer_size - 1)
            | (h_new <= c.h_min * 2) | ~torch.isfinite(y_out).all())
    go = ~dead & (t_out < c.t_end - 1e-9 * torch.abs(c.t_end))
    return (t_out, y_out, h_new, k_new, ts_h, fs_h, n_hist, n_acc, n_step,
            go)


def _block(rhs, st: _State, c: _Consts, max_steps: int,
           buffer_size: int) -> None:
    """BLOCK_STEPS attempts of the solve in st, updated in place; no host
    read.  A stopped solve's attempts change nothing."""
    cur = list(st[:9])
    stop = st.stop
    for _ in range(BLOCK_STEPS):
        t, y, h, k, ts_h, fs_h, n_hist, n_acc, n_step = cur
        out = _attempt(rhs, t, y, h, k, ts_h, fs_h, n_hist, c)
        slot = n_acc.reshape(1)
        st.rec_t.index_copy_(0, slot, t.reshape(1))
        st.rec_h.index_copy_(0, slot, out[3].reshape(1))
        st.rec_y.index_copy_(0, slot, y[None])
        st.rec_n.index_copy_(0, slot, out[8][None])
        st.rec_d.index_copy_(0, slot, out[9][None])
        new = _advance(t, y, ts_h, fs_h, n_hist, n_acc, n_step, out, c,
                       max_steps, buffer_size)
        live = ~stop
        cur = [torch.where(live, a, b) for a, b in zip(new[:9], cur)]
        stop = stop | (live & ~new[9])
    for dst, src in zip(st[:10], cur + [stop]):
        dst.copy_(src)


def _dense(ts, y0, rec_t, rec_h, rec_y, rec_n, rec_d, n_acc: int, ok: bool,
           c: _Consts):
    """Phase 2: each output time integrates its step's stored corrector
    polynomial from the step's start (inf unless ok)."""
    if not ok:
        return torch.full((ts.shape[0],) + tuple(y0.shape), float("inf"),
                          dtype=y0.dtype, device=y0.device)
    bt = rec_t[:n_acc]
    idx = torch.clamp(torch.searchsorted(bt, ts, right=True) - 1, 0,
                      n_acc - 1)
    t_from, h_rec = bt[idx], rec_h[idx]
    frac = torch.clamp((ts - t_from) / h_rec, 0.0, 1.0)
    half = frac * 0.5
    tau = half[:, None] * (c.glx + 1.0)[None, :]               # [T, 7]
    diff = tau[:, :, None] - rec_n[idx][:, None, :]            # [T, 7, H]
    basis = torch.cumprod(
        torch.cat([torch.ones_like(diff[:, :, :1]), diff[:, :, :H - 1]],
                  dim=-1), dim=-1)
    integ = half[:, None] * torch.einsum("q,tqj->tj", c.glw, basis)
    ys = rec_y[idx] + h_rec[:, None] * torch.einsum("tj,tjs->ts", integ,
                                                    rec_d[idx])
    ys[0] = y0
    return ys


def _finish(ts, y0, t, y, n_acc, n_step, c, return_stats, records):
    ok = (bool(t >= c.t_end - 1e-6) and bool(torch.all(torch.isfinite(y)))
          and n_acc > 0)
    ys = _dense(ts, y0, *records, n_acc, ok, c)
    if return_stats:
        return ys, SolveStats(ok=ok, n_accepted=n_acc, n_steps=n_step)
    return ys


def odeint_vcabm(
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
        ("vcabm", int(max_steps), int(buffer_size)), fn, args, st, c)
    n_acc, n_step = torch.stack([st.n_acc, st.n_step]).tolist()
    return _finish(ts, y0, st.t, st.y, n_acc, n_step, c, return_stats,
                   st[10:])


def _vcabm_stepwise(
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
    """``odeint_vcabm`` with one host read per step: the plain reference
    the blocked loop is held against (tests and chip_smoke.py only)."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    ts = ts.to(y0.dtype)
    c, st = _setup(rhs, y0, ts, rtol, atol, buffer_size)
    t, y, h, k, ts_h, fs_h, n_hist, n_acc, n_step = st[:9]
    recs = ([], [], [], [], [])
    while True:
        out = _attempt(rhs, t, y, h, k, ts_h, fs_h, n_hist, c)
        if bool(out[0]):
            for r, x in zip(recs, (t, out[3], y, out[8], out[9])):
                r.append(x)
        (t, y, h, k, ts_h, fs_h, n_hist, n_acc, n_step, go) = _advance(
            t, y, ts_h, fs_h, n_hist, n_acc, n_step, out, c, max_steps,
            buffer_size)
        if not bool(go):
            break
    n = int(n_acc)
    records = tuple(torch.stack(r) for r in recs) if n else (None,) * 5
    return _finish(ts, y0, t, y, n, int(n_step), c, return_stats, records)
