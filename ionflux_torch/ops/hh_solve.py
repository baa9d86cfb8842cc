"""Fused solves of a candidate-HH parameter POPULATION on one shared protocol
(counterpart of ``ionflux/ops/pallas_solve.py::fused_hh_pop_solve_ft`` and
``ionflux/ops/pallas_rk4.py::fused_hh_rk4``).

- ``fused_hh_pop_solve_ft``: adaptive DP5(4) for B <= 128 per-lane parameter
  sets [B, 8] on one shared step clock, the shape of the CMA-ES whole-trace
  objective.  It is the trip algorithm of ``ops/fused_solve.py`` with the HH
  right-hand side, a per-lane ``y0`` carry (a non-finite carry keeps its lane
  dead along a chain of sweeps) and the binding-ratio pace cull: bounded
  gates cannot blow up, so a wild candidate shows as stiffness that pins the
  shared step; once the launch falls behind its trip budget, a lane whose
  error ratio at block end is > 0.01 in two blocks in a row is culled and
  returns inf alone.
- ``fused_hh_rk4``: classical RK4 with ``n_sub`` substeps per output
  interval for the same population; no controller, no records.

Each wrapper sends a CPU tensor to the plain PyTorch version (``*_plain``)
and a CUDA tensor to the hand-written kernel in ``csrc/hh_solve.cu``; it
never falls back from one to the other.  ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ionflux_torch.ops.fused_solve import (
    SWEEP_BLOCK,
    _check_f32,
    _dense_eval_ft,
    _pad_knots,
    _trip_loop_plain,
)

MAX_LANES = 128


def _check_population(params: torch.Tensor, proto_v: torch.Tensor) -> int:
    _check_f32("params", params, 2)
    _check_f32("proto_v", proto_v, 1)
    b = params.shape[0]
    if params.shape[1] != 8:
        raise ValueError(f"params must be [B, 8], got {tuple(params.shape)}")
    if b > MAX_LANES:
        raise ValueError(f"the HH population kernels take at most "
                         f"{MAX_LANES} lanes (got B={b})")
    if b < 1 or proto_v.shape[0] < 2:
        raise ValueError("need at least one lane and two protocol knots")
    if params.device != proto_v.device:
        raise ValueError(f"params are on {params.device}, the protocol on "
                         f"{proto_v.device}")
    return b


def _hh_rates(params: torch.Tensor, v: torch.Tensor):
    """k1..k4 [..., B] of every lane at voltages v [...]."""
    v = v[..., None]
    p = params
    return (p[:, 0] * torch.exp(p[:, 1] * v),
            p[:, 2] * torch.exp(-p[:, 3] * v),
            p[:, 4] * torch.exp(p[:, 5] * v),
            p[:, 6] * torch.exp(-p[:, 7] * v))


def _hh_deriv(rates, a, r):
    k1, k2, k3, k4 = rates
    return k1 * (1.0 - a) - k2 * a, -k3 * r + k4 * (1.0 - r)


# ---------------------------------------------------------------------------
# The adaptive population solve
# ---------------------------------------------------------------------------


def _hh_pop_solve(params, proto_v, y0, *, proto_t0, proto_dt, t_end, rtol,
                  atol, trips, plain):
    """Phase 1 of the population solve, by either route: (rec_sc [trips, 2],
    rec_y [trips, 1, B, 2], rec_k [trips, 7, 1, B, 2], n_out int32 [2] =
    (n_acc or its shortfall code, n_valid), alive bool [B])."""
    b = _check_population(params, proto_v)
    dev = params.device
    if y0 is None:
        y0 = torch.zeros((b, 2), dtype=torch.float32, device=dev)
        y0[:, 1] = 1.0
    else:
        _check_f32("y0", y0, 2)
        if tuple(y0.shape) != (b, 2) or y0.device != dev:
            raise ValueError(f"y0 must be [{b}, 2] on {dev}, got "
                             f"{tuple(y0.shape)} on {y0.device}")
    trips = -(-int(trips) // SWEEP_BLOCK) * SWEEP_BLOCK
    vpad = _pad_knots(proto_v[None])[0]
    n_pad = vpad.shape[0]
    t0, dt = float(proto_t0), float(proto_dt)
    if plain or not params.is_cuda:
        inv_dt = 1.0 / dt

        def rhs_all(t, y):                             # y [1, B, 2]
            x = (t - t0) * inv_dt
            ii = torch.clamp(torch.floor(x).to(torch.int64), 0, n_pad - 130)
            w = x - ii.to(torch.float32)
            v = vpad[ii] + w * (vpad[ii + 1] - vpad[ii])
            da, dr = _hh_deriv(_hh_rates(params, v), y[0, :, 0], y[0, :, 1])
            return torch.stack([da, dr], dim=-1)[None]

        rec_sc, rec_y, rec_k, n_out, alive = _trip_loop_plain(
            rhs_all, y0[None], t0=t0, t_end=t_end, dt_knot=dt, rtol=rtol,
            atol=atol, trips=trips, block=SWEEP_BLOCK, cull="ratio")
        return rec_sc, rec_y, rec_k, n_out, alive[0]

    from ionflux_torch.ops._build import launch

    rec_sc = torch.empty((trips, 2), dtype=torch.float32, device=dev)
    rec_y = torch.empty((trips, 1, b, 2), dtype=torch.float32, device=dev)
    rec_k = torch.empty((trips, 7, 1, b, 2), dtype=torch.float32, device=dev)
    n_out = torch.empty(2, dtype=torch.int32, device=dev)
    alive = torch.empty(b, dtype=torch.uint8, device=dev)
    params, y0 = params.contiguous(), y0.contiguous()
    f = np.float32
    scal = (ctypes.c_float * 8)(f(t0), f(1.0 / dt), f(dt * 10.0), f(t_end),
                                f(t_end - t0), f(rtol), f(atol),
                                f(float(trips)))
    launch("hh_solve", "ionflux_hh_trip_solve", dev, vpad.data_ptr(),
           params.data_ptr(), y0.data_ptr(), rec_sc.data_ptr(),
           rec_y.data_ptr(), rec_k.data_ptr(), n_out.data_ptr(),
           alive.data_ptr(), b, n_pad, trips, SWEEP_BLOCK, scal)
    fused_hh_pop_solve_ft.launches += 1
    return rec_sc, rec_y, rec_k, n_out, alive.bool()


def _hh_pop(params, proto_v, ts, *, proto_t0, proto_dt, t_end, rtol, atol,
            trips, y0, plain):
    t_end = float(t_end) if t_end is not None else float(ts[-1])
    rec_sc, rec_y, rec_k, n_out, alive = _hh_pop_solve(
        params, proto_v, y0, proto_t0=proto_t0, proto_dt=proto_dt,
        t_end=t_end, rtol=float(rtol), atol=float(atol), trips=trips,
        plain=plain)
    return _dense_eval_ft(rec_sc, rec_y, rec_k, n_out[0], n_out[1], ts,
                          lane_ok=alive)


def fused_hh_pop_solve_ft(params: torch.Tensor, proto_v: torch.Tensor,
                          ts: torch.Tensor, *, proto_t0: float = 0.0,
                          proto_dt: float = 0.1, t_end: float | None = None,
                          rtol: float = 1e-5, atol: float = 1e-7,
                          trips: int = 2048,
                          y0: torch.Tensor | None = None) -> torch.Tensor:
    """Fixed-trip ADAPTIVE fused solve of B <= 128 candidate-HH parameter
    sets ``params`` [B, 8] on ONE shared protocol ``proto_v`` [N]: ys
    [B, T, 2].  ``trips`` is rounded up to a multiple of 256 and must exceed
    the attempts the solve needs, or every output is inf.  ``y0`` [B, 2]
    seeds each lane, so chained sweep launches carry the previous sweep's
    final state; a non-finite ``y0`` starts its lane dead.  A lane that
    diverges, or a stiff one that the pace cull reaps, returns inf alone.
    CUDA tensors run the kernel; CPU tensors run
    ``fused_hh_pop_solve_ft_plain``."""
    return _hh_pop(params, proto_v, ts, proto_t0=proto_t0, proto_dt=proto_dt,
                   t_end=t_end, rtol=rtol, atol=atol, trips=trips, y0=y0,
                   plain=False)


fused_hh_pop_solve_ft.launches = 0


def fused_hh_pop_solve_ft_plain(params: torch.Tensor, proto_v: torch.Tensor,
                                ts: torch.Tensor, *, proto_t0: float = 0.0,
                                proto_dt: float = 0.1,
                                t_end: float | None = None,
                                rtol: float = 1e-5, atol: float = 1e-7,
                                trips: int = 2048,
                                y0: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """The plain PyTorch version of ``fused_hh_pop_solve_ft``, on any
    device."""
    return _hh_pop(params, proto_v, ts, proto_t0=proto_t0, proto_dt=proto_dt,
                   t_end=t_end, rtol=rtol, atol=atol, trips=trips, y0=y0,
                   plain=True)


# ---------------------------------------------------------------------------
# Fixed-step RK4
# ---------------------------------------------------------------------------


def _rk4_plain(params, proto_v, t0, dt, dt_out, n_out, n_sub, y0):
    """n_out - 1 intervals of n_sub RK4 substeps, one host-paced chain of
    torch ops per substep.  The substep times and the rates at them do not
    depend on the state, so each interval computes them for all its
    substeps at once."""
    f32 = torch.float32
    dev = params.device
    b, n = params.shape[0], proto_v.shape[0]
    h = dt_out / n_sub
    inv_dt = 1.0 / dt
    a = torch.full((b,), float(y0[0]), dtype=f32, device=dev)
    r = torch.full((b,), float(y0[1]), dtype=f32, device=dev)
    out = [torch.stack([a, r], dim=-1)]
    sub_i = torch.arange(n_sub, dtype=f32, device=dev)
    for oi in range(1, n_out):
        tbase = t0 + torch.tensor(float(oi - 1), dtype=f32,
                                  device=dev) * dt_out
        t = tbase + sub_i * h                                      # [n_sub]
        tt = torch.stack([t, t + 0.5 * h, t + h], dim=-1)          # [n_sub, 3]
        x = (tt - t0) * inv_dt
        ii = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
        w = x - ii.to(f32)
        v = proto_v[ii] + w * (proto_v[ii + 1] - proto_v[ii])
        k = _hh_rates(params, v)                         # 4 x [n_sub, 3, B]
        for i in range(n_sub):
            at, mid, end = ([kk[i, s] for kk in k] for s in range(3))
            a1, r1 = _hh_deriv(at, a, r)
            a2, r2 = _hh_deriv(mid, a + 0.5 * h * a1, r + 0.5 * h * r1)
            a3, r3 = _hh_deriv(mid, a + 0.5 * h * a2, r + 0.5 * h * r2)
            a4, r4 = _hh_deriv(end, a + h * a3, r + h * r3)
            a = a + (h / 6.0) * (a1 + 2 * a2 + 2 * a3 + a4)
            r = r + (h / 6.0) * (r1 + 2 * r2 + 2 * r3 + r4)
        out.append(torch.stack([a, r], dim=-1))
    return torch.stack(out, dim=1)                       # [B, n_out, 2]


def _rk4(params, proto_v, *, proto_t0, proto_dt, dt_out, n_out, n_sub, y0,
         plain):
    b = _check_population(params, proto_v)
    n_out, n_sub = int(n_out), int(n_sub)
    if n_out < 1 or n_sub < 1:
        raise ValueError(f"n_out and n_sub must be >= 1, got {n_out}, "
                         f"{n_sub}")
    t0, dt, dt_out = float(proto_t0), float(proto_dt), float(dt_out)
    if plain or not params.is_cuda:
        return _rk4_plain(params, proto_v, t0, dt, dt_out, n_out, n_sub, y0)

    from ionflux_torch.ops._build import launch

    dev = params.device
    out = torch.empty((n_out, b, 2), dtype=torch.float32, device=dev)
    params, proto_v = params.contiguous(), proto_v.contiguous()
    h = dt_out / n_sub
    f = np.float32
    scal = (ctypes.c_float * 8)(f(t0), f(1.0 / dt), f(dt_out), f(h),
                                f(0.5 * h), f(h / 6.0), f(y0[0]), f(y0[1]))
    launch("hh_solve", "ionflux_hh_rk4", dev, proto_v.data_ptr(),
           params.data_ptr(), out.data_ptr(), b, proto_v.shape[0], n_out,
           n_sub, scal)
    fused_hh_rk4.launches += 1
    return out.permute(1, 0, 2).contiguous()


def fused_hh_rk4(params: torch.Tensor, proto_v: torch.Tensor, *,
                 proto_t0: float = 0.0, proto_dt: float = 0.1, dt_out: float,
                 n_out: int, n_sub: int = 10,
                 y0: tuple = (0.0, 1.0)) -> torch.Tensor:
    """Fixed-step RK4 solve of B <= 128 candidate-HH parameter sets
    ``params`` [B, 8] on ONE shared protocol ``proto_v`` [N]: ys
    [B, n_out, 2] at t0 + k * dt_out, with ``n_sub`` substeps per output
    interval, all lanes from the state ``y0``.  V(t) is interpolated with
    the knot index clamped to [0, N - 2].  CUDA tensors run the kernel; CPU
    tensors run ``fused_hh_rk4_plain``."""
    return _rk4(params, proto_v, proto_t0=proto_t0, proto_dt=proto_dt,
                dt_out=dt_out, n_out=n_out, n_sub=n_sub, y0=y0, plain=False)


fused_hh_rk4.launches = 0


def fused_hh_rk4_plain(params: torch.Tensor, proto_v: torch.Tensor, *,
                       proto_t0: float = 0.0, proto_dt: float = 0.1,
                       dt_out: float, n_out: int, n_sub: int = 10,
                       y0: tuple = (0.0, 1.0)) -> torch.Tensor:
    """The plain PyTorch version of ``fused_hh_rk4``, on any device."""
    return _rk4(params, proto_v, proto_t0=proto_t0, proto_dt=proto_dt,
                dt_out=dt_out, n_out=n_out, n_sub=n_sub, y0=y0, plain=True)
