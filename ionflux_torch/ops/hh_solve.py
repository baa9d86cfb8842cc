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
kernel launches (``ops._build.count_launch``: a launch inside a CUDA graph
counts at each replay), and ``<wrapper>.last_layout`` holds the layout the
kernel reported for its last launch.  ``hh_trip_geometry`` and
``rk4_geometry`` are the kernels' layout rules (threads per lane, lanes per
block).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ionflux_torch.ops._build import count_launch
from ionflux_torch.ops.fused_solve import (
    _SMEM_BYTES,
    SWEEP_BLOCK,
    _check_f32,
    _dense_eval_ft,
    _pad_knots,
    _trip_loop_plain,
)

MAX_LANES = 128
MAX_THREADS = 512            # a block's threads (kMaxThreads in the kernel)
TRIP_RATES = 20              # 5 distinct stage voltages x k1..k4 per trip
TRIP_RECORDS = 8             # start y and 7 stages, float2 each
TRIP_GROUPS = (20, 10, 5, 4, 3)  # helpers per lane: the rule's choices,
                                 # the kernel's instantiations
RK4_RATES = 12               # 3 distinct voltages x k1..k4 per substep
RK4_CHUNK = 32               # substeps per slot of the RK4 ring
RK4_LANES = 2                # lanes per RK4 block (kRk4Lanes in the kernel)


def _warps(n: int) -> int:
    return -(-n // 32) * 32


def hh_trip_geometry(b: int) -> dict:
    """How the trip kernel lays out B lanes in its one block: chain warps
    first (thread l < B runs lane l's chain; ceil(B / 32) warps), then G
    helper threads per lane (helper h serves lane h % B as member h // B,
    computing the lane's rates member, member + G, ... < 20 and copying its
    records member, member + G, ... < 8).  The rule: the largest G of
    TRIP_GROUPS whose threads fit MAX_THREADS: 20 (one rate per helper) up
    to 24 lanes, 10 up to 44, 5 up to 83, 4 up to 96 and 3 up to 128.
    Returns {group, threads, chain_warps, smem_bytes}."""
    if not 1 <= b <= MAX_LANES:
        raise ValueError(f"the trip kernel takes 1..{MAX_LANES} lanes, got "
                         f"{b}")
    threads = lambda g: _warps(b) + _warps(b * g)
    group = next(g for g in TRIP_GROUPS if threads(g) <= MAX_THREADS)
    # rates [20][128], records [2][8][128] float2, voltages, partials
    smem = (4 * TRIP_RATES * MAX_LANES + 2 * 8 * TRIP_RECORDS * MAX_LANES
            + 32 + 16)
    return dict(group=group, threads=threads(group),
                chain_warps=-(-b // 32), smem_bytes=smem)


def _trip_roles(b: int):
    """Which thread does what in the trip kernel at the rule's layout, by
    its index arithmetic: (chain [B]: the thread of each lane's chain, rate
    [B, 20]: the thread computing each rate, record [B, 8]: the thread
    copying each record; -1 where none does)."""
    geo = hh_trip_geometry(b)
    group = geo["group"]
    n_chain = 32 * geo["chain_warps"]
    chain = np.full(b, -1)
    rate = np.full((b, TRIP_RATES), -1)
    record = np.full((b, TRIP_RECORDS), -1)
    for t in range(geo["threads"]):
        if t < n_chain:
            if t < b:
                chain[t] = t
            continue
        lane, g = (t - n_chain) % b, (t - n_chain) // b
        if g < group:
            rate[lane, g::group] = t
            record[lane, g::group] = t
    return chain, rate, record


def rk4_geometry(b: int) -> dict:
    """How the RK4 kernel spreads B independent lanes: RK4_LANES per block,
    each block one consumer warp (thread l runs the chain of lane l) and
    ceil(12 lanes / 32) producer warps (thread p owns the (lane, rate)
    pairs p, p + producers, ...), with a two-slot ring of RK4_CHUNK
    substeps x lanes x 12 rates.  Returns {lanes_per_block, blocks,
    threads, producers, smem_bytes}."""
    if not 1 <= b <= MAX_LANES:
        raise ValueError(f"the RK4 kernel takes 1..{MAX_LANES} lanes, got "
                         f"{b}")
    lanes = RK4_LANES
    producers = -(-lanes * RK4_RATES // 32) * 32
    return dict(lanes_per_block=lanes, blocks=-(-b // lanes),
                threads=32 + producers, producers=producers,
                smem_bytes=4 * 2 * RK4_CHUNK * lanes * RK4_RATES + 32)


def _rk4_roles(b: int):
    """Which thread of which block does what in the RK4 kernel: (consumer
    [B]: (block, thread) of each lane's chain, producer [B, 12]: (block,
    thread) computing each of a lane's rates)."""
    geo = rk4_geometry(b)
    lanes = geo["lanes_per_block"]
    consumer = np.full((b, 2), -1)
    producer = np.full((b, RK4_RATES, 2), -1)
    for blk in range(geo["blocks"]):
        l0 = blk * lanes
        nl = min(lanes, b - l0)
        for t in range(nl):
            consumer[l0 + t] = (blk, t)
        for p in range(geo["producers"]):
            for e in range(p, nl * RK4_RATES, geo["producers"]):
                producer[l0 + e // RK4_RATES, e % RK4_RATES] = (blk, 32 + p)
    return consumer, producer


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
    layout = (ctypes.c_int * 3)()
    launch("hh_solve", "ionflux_hh_trip_solve", dev, vpad.data_ptr(),
           params.data_ptr(), y0.data_ptr(), rec_sc.data_ptr(),
           rec_y.data_ptr(), rec_k.data_ptr(), n_out.data_ptr(),
           alive.data_ptr(), b, n_pad, trips, SWEEP_BLOCK,
           hh_trip_geometry(b)["group"], scal, layout)
    count_launch(fused_hh_pop_solve_ft)
    fused_hh_pop_solve_ft.last_layout = dict(
        zip(("group", "threads", "chain_warps"), layout))
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
fused_hh_pop_solve_ft.last_layout = None


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
    layout = (ctypes.c_int * 3)()
    launch("hh_solve", "ionflux_hh_rk4", dev, proto_v.data_ptr(),
           params.data_ptr(), out.data_ptr(), b, proto_v.shape[0], n_out,
           n_sub, scal, layout)
    count_launch(fused_hh_rk4)
    fused_hh_rk4.last_layout = dict(
        zip(("lanes_per_block", "blocks", "threads"), layout))
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
fused_hh_rk4.last_layout = None


def fused_hh_rk4_plain(params: torch.Tensor, proto_v: torch.Tensor, *,
                       proto_t0: float = 0.0, proto_dt: float = 0.1,
                       dt_out: float, n_out: int, n_sub: int = 10,
                       y0: tuple = (0.0, 1.0)) -> torch.Tensor:
    """The plain PyTorch version of ``fused_hh_rk4``, on any device."""
    return _rk4(params, proto_v, proto_t0=proto_t0, proto_dt=proto_dt,
                dt_out=dt_out, n_out=n_out, n_sub=n_sub, y0=y0, plain=True)
