"""Batched-lane adaptive dopri5: B systems in lockstep under ONE controller
(counterpart of ``ionflux/solver/batched.py``).

The step index is a scalar, the record buffers are [buffer_size + 1, ...]
written at slot ``n_acc`` (slot ``buffer_size`` takes a rejected attempt),
and the controller is shared: a step is accepted when the largest error
ratio over the live lanes passes (each lane still meets its own tolerance;
the lanes share step boundaries).  Divergence is isolated per lane: a live
lane that is non-finite, or still fails at ``h_eff <= 2 h_min``, leaves the
controller, freezes, and returns inf; the other lanes keep their accuracy
(one bad CMA-ES member must not erase a generation's ranking).

The step loop is paced on the device as ``solver.dopri5.odeint``'s is:
blocks of ``BLOCK_STEPS`` steps with one host read per block, a block
captured once as a CUDA graph per (right-hand side, argument structure and
shapes, settings) and replayed on the card; a solve that has stopped makes
its block's later steps change nothing.  ``_odeint_batched_stepwise`` keeps
the per-step loop with a host read per step as the plain reference; both
loops share ``_attempt``, so they give the same results bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ionflux_torch.solver.dopri5 import (
    _A,
    _B_ERR,
    _B_SOL,
    _C,
    _P_DENSE,
    BLOCK_STEPS,
    MAX_FACTOR,
    MIN_FACTOR,
    SAFETY,
    SolveStats,
    _initial_step,
    _rk_step,
    _run_blocks,
)


class _Consts(NamedTuple):
    """A batched solve's fixed tensors."""

    tab: tuple
    rtol: torch.Tensor
    atol: torch.Tensor
    t_end: torch.Tensor
    h_min: torch.Tensor
    h_cap: torch.Tensor     # the step bound while anything sleeps


class _State(NamedTuple):
    """A batched solve's state and records on its device."""

    t: torch.Tensor        # 0-d
    h: torch.Tensor        # 0-d
    y: torch.Tensor        # [B, S]
    f: torch.Tensor        # [B, S]
    n_acc: torch.Tensor    # 0-d int64
    n_step: torch.Tensor   # 0-d int64
    stop: torch.Tensor     # 0-d bool
    lane_ok: torch.Tensor  # [B] bool
    frozen: torch.Tensor   # [B, S] bool: asleep (sleep_tol only)
    lam: torch.Tensor      # [B, S]: contraction-rate estimate (sleep_tol)
    rec_t: torch.Tensor    # [nbuf + 1]
    rec_h: torch.Tensor    # [nbuf + 1]
    rec_y: torch.Tensor    # [nbuf + 1, B, S]
    rec_k: torch.Tensor    # [nbuf + 1, 7, B, S]


def _settled(t, y, f, lam, c: _Consts, sleep_tol: float):
    """[B, S]: components safe to freeze, either slow (worst-case drift
    |f| (t_end - t) inside sleep_tol * tol) or contracting with rate lam
    and within sleep_tol * tol of their moving equilibrium (|f| / lam)."""
    span = torch.maximum(c.t_end - t, c.h_min)
    scale = c.atol + c.rtol * torch.abs(y)
    return torch.abs(f) <= sleep_tol * scale * torch.maximum(lam, 1.0 / span)


def _attempt(rhs, st: _State, c: _Consts, sleep_tol, max_steps: int,
             nbuf: int):
    """One attempted step from st.  Returns the record (t, h_eff, y, K),
    ``accept`` and the state after the step (t, h, y, f, n_acc, n_step,
    lane_ok, frozen, lam) and whether the solve stops there."""
    t, h, y, f = st.t, st.h, st.y, st.f
    lane_ok, frozen, lam = st.lane_ok, st.frozen, st.lam
    h_lim = h
    if sleep_tol is not None:
        h_lim = torch.minimum(h, torch.where(
            torch.any(frozen), c.h_cap, torch.full_like(h, torch.finfo(
                h.dtype).max)))
    h_eff = torch.maximum(torch.minimum(h_lim, c.t_end - t), c.h_min)

    if sleep_tol is not None:
        # frozen components are constants of the vector field: their stage
        # derivatives are masked to zero, so they keep y through every stage
        zero = torch.zeros((), dtype=y.dtype, device=y.device)
        rhs_step = lambda tt, yy: torch.where(  # noqa: E731
            frozen, zero, rhs(tt, yy))
    else:
        rhs_step = rhs
    y1, f1, k, err = _rk_step(rhs_step, t, y, f, h_eff, c.tab)
    scale = c.atol + c.rtol * torch.maximum(torch.abs(y), torch.abs(y1))
    if sleep_tol is not None:
        # wake probe at the candidate end state: a frozen component is
        # charged a first-order drift error |f_probe| h, so a step across a
        # forcing change is rejected and retried smaller
        f_probe = rhs(t + h_eff, y1)
        err = err + torch.where(frozen, f_probe * h_eff, zero)
    ratio_l = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))     # [B]
    lane_fin = torch.all(torch.isfinite(y1), dim=-1) & torch.isfinite(
        ratio_l)
    # the shared accept on the worst live lane; dead lanes never block
    any_bad = torch.any(lane_ok & ~lane_fin)
    ratio = torch.max(torch.where(lane_ok & lane_fin, ratio_l,
                                  torch.zeros_like(ratio_l)))
    accept = (ratio <= 1.0) & ~any_bad
    # a live lane that cannot pass even at the minimum step is dead
    lane_pass = lane_fin & (ratio_l <= 1.0)
    lane_ok2 = lane_ok & (lane_pass | (h_eff > c.h_min * 2))

    adv = accept & lane_ok2                                          # [B]
    t_new = torch.where(accept, t + h_eff, t)
    y_new = torch.where(adv[:, None], y1, y)
    if sleep_tol is not None:
        # on accept the probe is the new state's full right-hand side;
        # lam ~ |df/dy| from the step just taken (active components only)
        dy = torch.abs(y1 - y)
        df = torch.abs(f_probe - torch.where(frozen, f_probe, f))
        upd = adv[:, None] & ~frozen & (dy > 1e-3 * scale)
        lam2 = torch.where(upd, df / torch.clamp(dy, min=1e-30), lam)
        frozen2 = torch.where(
            accept, _settled(t_new, y_new, f_probe, lam2, c, sleep_tol)
            & torch.isfinite(f_probe), frozen)
        f_new = torch.where(accept, torch.where(frozen2, zero, f_probe), f)
    else:
        f_new = torch.where(adv[:, None], f1, f)
        frozen2, lam2 = frozen, lam
    n_acc2 = st.n_acc + accept.to(torch.int64)
    factor = SAFETY * torch.pow(torch.clamp(ratio, min=1e-10), -0.2)
    # a non-finite live lane: shrink hard (rescues a transient overflow; if
    # it persists to h_min the lane is declared dead above)
    factor = torch.where(any_bad | ~torch.isfinite(factor),
                         torch.full_like(factor, MIN_FACTOR), factor)
    max_up = torch.where(accept, torch.full_like(factor, MAX_FACTOR),
                         torch.ones_like(factor))
    h_new = h_eff * torch.minimum(torch.clamp(factor, min=MIN_FACTOR),
                                  max_up)
    n2 = st.n_step + 1
    stop = ((t_new >= c.t_end) | ~torch.any(lane_ok2) | (n2 >= max_steps)
            | (n_acc2 >= nbuf))
    return ((t, h_eff, y, k), accept,
            (t_new, h_new, y_new, f_new, n_acc2, n2, lane_ok2, frozen2,
             lam2), stop)


def _block(rhs, st: _State, c: _Consts, sleep_tol, max_steps: int,
           nbuf: int) -> None:
    """BLOCK_STEPS steps of the solve in st, updated in place; no host read.
    A stopped solve's steps change nothing."""
    cur = st
    for _ in range(BLOCK_STEPS):
        (rt, rh, ry, rk), accept, new, stop = _attempt(
            rhs, cur, c, sleep_tol, max_steps, nbuf)
        live = ~cur.stop
        slot = torch.where(accept & live, cur.n_acc,
                           torch.full_like(cur.n_acc, nbuf)).reshape(1)
        st.rec_t.index_copy_(0, slot, rt.reshape(1))
        st.rec_h.index_copy_(0, slot, rh.reshape(1))
        st.rec_y.index_copy_(0, slot, ry[None])
        st.rec_k.index_copy_(0, slot, rk[None])
        vals = [torch.where(live, n, o) for n, o in zip(
            new, (cur.t, cur.h, cur.y, cur.f, cur.n_acc, cur.n_step,
                  cur.lane_ok, cur.frozen, cur.lam))]
        cur = cur._replace(
            t=vals[0], h=vals[1], y=vals[2], f=vals[3], n_acc=vals[4],
            n_step=vals[5], lane_ok=vals[6], frozen=vals[7], lam=vals[8],
            stop=cur.stop | (live & stop))
    for dst, src in zip(st[:10], cur[:10]):
        dst.copy_(src)


def _start(rhs, ts, y0, rtol, atol, sleep_tol, sleep_h_max, buffer_size):
    """The solve's constants and its first state."""
    dtype, dev = y0.dtype, y0.device
    t0, t_end = ts[0], ts[-1]
    b, s = y0.shape
    big = torch.finfo(dtype).max
    c = _Consts(
        tuple(torch.as_tensor(x, dtype=dtype, device=dev)
              for x in (_C, _A, _B_SOL, _B_ERR)),
        torch.tensor(rtol, dtype=dtype, device=dev),
        torch.tensor(atol, dtype=dtype, device=dev),
        t_end, torch.clamp(t_end - t0, min=1.0) * 1e-12,
        torch.tensor(sleep_h_max if sleep_h_max is not None else big,
                     dtype=dtype, device=dev))
    f0 = rhs(t0, y0)
    h0 = _initial_step(rhs, t0, y0, f0, c.rtol, c.atol)
    # lanes that start non-finite are dead from step 0
    lane_ok0 = torch.all(torch.isfinite(y0), dim=-1) & torch.all(
        torch.isfinite(f0), dim=-1)
    lam0 = torch.zeros((b, s), dtype=dtype, device=dev)
    if sleep_tol is not None:
        frozen0 = _settled(t0, y0, f0, lam0, c, sleep_tol) & lane_ok0[:, None]
        f0 = torch.where(frozen0, torch.zeros((), dtype=dtype, device=dev),
                         f0)
    else:
        frozen0 = torch.zeros((b, s), dtype=torch.bool, device=dev)
    n = buffer_size + 1
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    st = _State(
        t0.clone(), h0.clone(), y0.clone(), f0.clone(), zero, zero.clone(),
        torch.zeros((), dtype=torch.bool, device=dev), lane_ok0, frozen0,
        lam0, torch.full((n,), big, dtype=dtype, device=dev),
        torch.ones(n, dtype=dtype, device=dev),
        torch.zeros((n, b, s), dtype=dtype, device=dev),
        torch.zeros((n, 7, b, s), dtype=dtype, device=dev))
    return c, st


def _finish(ts, y0, st: _State, c: _Consts, return_stats: bool):
    """Phase 2: the dense output ys [B, T, S] (inf on lanes that are not
    ok) from the first n_acc records."""
    dtype, dev = y0.dtype, y0.device
    ok = (st.lane_ok & (st.t >= c.t_end) & torch.all(torch.isfinite(st.y),
                                                     dim=-1))
    n_acc, n_step = torch.stack([st.n_acc, st.n_step]).tolist()
    ok = ok & (n_acc > 0)
    b, s = y0.shape
    if n_acc == 0:
        ys = torch.full((b, ts.shape[0], s), float("inf"), dtype=dtype,
                        device=dev)
    else:
        p_dense = torch.as_tensor(_P_DENSE, dtype=dtype, device=dev)
        bt, bh = st.rec_t[:n_acc], st.rec_h[:n_acc]
        idx = torch.clamp(torch.searchsorted(bt, ts, right=True) - 1, 0,
                          n_acc - 1)
        th = torch.clamp((ts - bt[idx]) / bh[idx], 0.0, 1.0)
        tp = torch.stack([th, th ** 2, th ** 3, th ** 4], dim=-1)   # [T, 4]
        bpoly = tp @ p_dense.T                                       # [T, 7]
        ys = st.rec_y[idx] + bh[idx][:, None, None] * torch.einsum(
            "tj,tjbs->tbs", bpoly, st.rec_k[idx])
        ys[0] = y0
        ys = ys.transpose(0, 1)                                      # [B, T, S]
        ys = torch.where(ok[:, None, None], ys,
                         torch.full((), float("inf"), dtype=dtype,
                                    device=dev))
    if return_stats:
        return ys, SolveStats(ok=ok, n_accepted=n_acc, n_steps=n_step)
    return ys


def _solve_blocked(fn, y0, ts, args, rtol, atol, max_steps, buffer_size,
                   sleep_tol, sleep_h_max):
    """Phase 1 by blocks: (the final state with its records, constants)."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    c, st = _start(rhs, ts, y0, rtol, atol, sleep_tol, sleep_h_max,
                   buffer_size)
    st = _run_blocks(
        lambda r, s, cc: _block(r, s, cc, sleep_tol, max_steps, buffer_size),
        ("odeint_batched", sleep_tol, int(max_steps), int(buffer_size)),
        fn, args, st, c)
    return st, c


def _solve_stepwise(fn, y0, ts, args, rtol, atol, max_steps, buffer_size,
                    sleep_tol, sleep_h_max):
    """Phase 1 one step at a time, a host read per step: (the final state
    with its records, constants)."""
    rhs = lambda t, y: fn(t, y, args)  # noqa: E731
    c, st = _start(rhs, ts, y0, rtol, atol, sleep_tol, sleep_h_max,
                   buffer_size)
    while True:
        rec, accept_t, new, stop_t = _attempt(rhs, st, c, sleep_tol,
                                              max_steps, buffer_size)
        accept, stop = torch.stack([accept_t, stop_t]).tolist()
        slot = int(st.n_acc) if accept else buffer_size
        for buf, x in zip(st[10:], rec):
            buf[slot] = x
        st = st._replace(
            t=new[0], h=new[1], y=new[2], f=new[3], n_acc=new[4],
            n_step=new[5], lane_ok=new[6], frozen=new[7], lam=new[8],
            stop=stop_t)
        if stop:
            return st, c


def odeint_batched(
    fn: Callable,
    y0: torch.Tensor,               # [B, S]
    ts: torch.Tensor,               # [T]
    args=None,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 4096,
    return_stats: bool = False,
    sleep_tol: float | None = None,
    sleep_h_max: float | None = None,
):
    """Integrate dy/dt = fn(t, y, args) for B systems in lockstep.

    fn maps (t, y [B, S], args) -> dy [B, S].  Returns ys [B, T, S] (and
    ``SolveStats`` with ``ok`` a [B] bool tensor if return_stats).  A lane
    that stays non-finite, or fails at the minimum step, is dead and
    returns inf; the others keep their accuracy.

    sleep_tol (opt-in) freezes a settled state component (its worst-case
    drift over the rest of the span, or for a contracting component its
    distance to equilibrium |f| / |df/dy|, inside sleep_tol * tol): its
    stage derivatives are masked to zero, so it leaves the shared error
    controller; every step's probe of the full right-hand side at the
    candidate state charges it a first-order drift error and wakes it when
    the forcing moves.  sleep_h_max bounds h while anything sleeps.

    On a CUDA device fn must be capturable (no host read, no host-to-device
    copy, no tensor in its closure), as for ``odeint``."""
    ts = ts.to(y0.dtype)
    st, c = _solve_blocked(fn, y0, ts, args, rtol, atol, max_steps,
                           buffer_size, sleep_tol, sleep_h_max)
    return _finish(ts, y0, st, c, return_stats)


def _odeint_batched_stepwise(
    fn: Callable,
    y0: torch.Tensor,
    ts: torch.Tensor,
    args=None,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_steps: int = 100_000,
    buffer_size: int = 4096,
    return_stats: bool = False,
    sleep_tol: float | None = None,
    sleep_h_max: float | None = None,
):
    """``odeint_batched`` with one host read per step: the plain reference
    the blocked loop is held against (tests and chip_smoke.py only)."""
    ts = ts.to(y0.dtype)
    st, c = _solve_stepwise(fn, y0, ts, args, rtol, atol, max_steps,
                            buffer_size, sleep_tol, sleep_h_max)
    return _finish(ts, y0, st, c, return_stats)


def odeint_batched_chunked(
    fn: Callable,
    y0: torch.Tensor,               # [B, S]
    ts: torch.Tensor,               # [T]
    args=None,
    *,
    max_lanes: int = 64,
    lane_leaf=None,
    sort_lanes: bool = False,
    **kw,
):
    """odeint_batched for large populations: the B lanes in chunks of
    <= max_lanes, solved one after another (JAX's ``lax.map``).

    sort_lanes=True orders the lanes by a stiffness proxy (the error-
    weighted |f(t0, y0)| that drives the initial step) before chunking, so
    similarly stiff members share a chunk's controller; results come back
    in the caller's lane order.

    Lane-carrying leaves of ``args`` are detected as tensors whose leading
    dimension equals B (override with ``lane_leaf``, a predicate leaf ->
    bool); a ``Protocol`` is always shared.  Shared leaves go to every
    chunk unchanged; fn sees chunk-shaped inputs (t, y [max_lanes, S],
    chunk_args).  The last chunk is padded with copies of the last lane."""
    from ionflux_torch.protocols import Protocol

    b = y0.shape[0]
    if b <= max_lanes:
        return odeint_batched(fn, y0, ts, args, **kw)
    if lane_leaf is None:
        def lane_leaf(x):
            return (isinstance(x, torch.Tensor) and x.dim() >= 1
                    and x.shape[0] == b)

    def tmap(f, tree):
        if isinstance(tree, Protocol):
            return tree
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*[tmap(f, v) for v in tree])
        if isinstance(tree, (tuple, list)):
            return type(tree)(tmap(f, v) for v in tree)
        if isinstance(tree, dict):
            return {k: tmap(f, v) for k, v in tree.items()}
        return f(tree)

    n_chunks = -(-b // max_lanes)
    pad = n_chunks * max_lanes - b
    inv = None
    if sort_lanes:
        rtol = kw.get("rtol", 1e-6)
        atol = kw.get("atol", 1e-8)
        f0 = fn(ts[0].to(y0.dtype), y0, args)
        scale = atol + rtol * torch.abs(y0)
        stiff = torch.sqrt(torch.mean(torch.square(f0 / scale), dim=-1))
        order = torch.argsort(stiff, stable=True)
        inv = torch.argsort(order, stable=True)
        y0 = y0[order]
        args = tmap(lambda x: x[order] if lane_leaf(x) else x, args)

    def padded(x):
        if pad:
            x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
        return x

    y0p = padded(y0)
    return_stats = kw.get("return_stats", False)
    ys_all, oks, n_acc, n_step = [], [], 0, 0
    for k in range(n_chunks):
        sl = slice(k * max_lanes, (k + 1) * max_lanes)
        args_k = tmap(lambda x: padded(x)[sl] if lane_leaf(x) else x, args)
        out = odeint_batched(fn, y0p[sl], ts, args_k, **kw)
        if return_stats:
            out, st = out
            oks.append(st.ok)
            n_acc = max(n_acc, st.n_accepted)
            n_step += st.n_steps
        ys_all.append(out)
    ys = torch.cat(ys_all)[:b]
    if return_stats:
        ok = torch.cat(oks)[:b]
        if inv is not None:
            ys, ok = ys[inv], ok[inv]
        return ys, SolveStats(ok=ok, n_accepted=n_acc, n_steps=n_step)
    return ys if inv is None else ys[inv]
