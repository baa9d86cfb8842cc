#!/usr/bin/env python
"""Study d0 on the ionflux_torch port: fit the candidate HH a-gate (p1-p4)
to synthetic 3-state-Markov data by CMA-ES on the whole concatenated Pr3+Pr5
current trace.

    python3 scripts/train_d0_torch.py [--myokit | --fused | --analytic]
                                      [--onchip] [--max-iterations N]

The PyTorch / CUDA counterpart of ``scripts/train_d0.py``, with its five
paths, chosen by its flags in its order:

- no flag: the lockstep objective, one batched-lane adaptive solve per sweep
  (``solver.odeint_batched``, device-paced: blocks of steps replayed as CUDA
  graphs on the card);
- ``--myokit``: the native C++ host solver (``ionflux_torch.native.csolve``),
  one member at a time;
- ``--fused``: one launch of the adaptive HH-population kernel
  (``ops/hh_solve.fused_hh_pop_solve_ft``) per sweep, 16 in all; on the card
  a generation is one replay of a CUDA graph of those launches, their dense
  output and the SSE;
- ``--analytic``: the exact piecewise-constant propagator
  (``solver.analytic.hh_solve_analytic_seg``), no ODE solve at all; on the
  card one graph replay a generation;
- ``--onchip``: the whole fit device-resident (``fit.cmaes.cmaes_onchip``)
  over the analytic objective, or over the fused one with ``--fused``.

Without ``--onchip`` CMA-ES runs on the host (``fit.cmaes.cmaes``).  The
recorded cell-5 Pr3/Pr5 voltage protocols drive everything
(``ionflux_torch.protorec``); the ground-truth data is the Markov model solved
per protocol from the rest state plus the seed-0 numpy noise stream drawn at
full 0.1 ms resolution; the fit scores the [::10] subsample of the
concatenated trace, with the candidate's state carried across sweeps and
across the Pr3->Pr5 boundary.

Runs on the card unless ``--device cpu`` is given (the plain PyTorch
versions, slow at the real size).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ionflux_torch import protocols as P  # noqa: E402
from ionflux_torch import protorec  # noqa: E402
from ionflux_torch._device import resolve_device  # noqa: E402
from ionflux_torch.fit.cmaes import (  # noqa: E402
    _default_popsize,
    cmaes,
    cmaes_onchip,
)
from ionflux_torch.models import MARKOV_Y0_REST, markov_rhs  # noqa: E402
from ionflux_torch.models.registry import (  # noqa: E402
    HH_B06,
    MARKOV_B06,
    SYNTHETIC,
)
from ionflux_torch.observe import NOISE_SIGMA  # noqa: E402
from ionflux_torch.ops._build import Graph  # noqa: E402
from ionflux_torch.ops.hh_solve import fused_hh_pop_solve_ft  # noqa: E402
from ionflux_torch.solver import odeint_batched, odeint_chained  # noqa: E402
from ionflux_torch.solver.analytic import (  # noqa: E402
    hh_segments,
    hh_solve_analytic_seg,
)

# CMA-ES initial guess = B06 HH a-gate
P0 = np.array([float(HH_B06.p1), float(HH_B06.p2),
               float(HH_B06.p3), float(HH_B06.p4)])
RGATE = (MARKOV_B06.p5, MARKOV_B06.p6, MARKOV_B06.p7, MARKOV_B06.p8)
SUB = 10  # data subsample [::10]
RECORDINGS = ("pr3-cell5", "pr5-cell5")
# the reference d0 fit's parameters (scripts/train_d0.py prints its
# found / reference ratios against them)
REF_D0 = np.array([5.694588454735844622e-05, 1.172955815858964107e-01,
                   3.522672347205991382e-05, 4.972513487995382231e-02])


def _recording(rec):
    """(name, per-sample voltage, dt, n_sweeps, period) of a recorded
    protocol's name, or of such a tuple itself (a stand-in)."""
    if isinstance(rec, str):
        v, dt = protorec.load_voltage(rec)
        return (rec, v, dt) + tuple(protorec.SWEEPS[rec])
    return rec


def _sweep_protos(rec, device=None):
    """Per-sweep protocols of one recording, each with a 1-sample overlap
    into the next sweep, plus the full-resolution local output grid.  The
    [::10] score lattice is applied on the FLAT per-protocol axis (Pr5's
    sweep period is not a multiple of 10, so the lattice phase shifts across
    sweeps)."""
    device = resolve_device(device)
    _, v, dt, n_sweeps, period = _recording(rec)
    v = np.asarray(v)
    vs = np.empty((n_sweeps, period + 1), v.dtype)
    vs[:, :period] = v.reshape(n_sweeps, period)
    vs[:-1, period] = vs[1:, 0]
    vs[-1, period] = vs[-1, period - 1]
    f32 = torch.float32
    protos = P.Protocol(
        torch.zeros(n_sweeps, dtype=f32, device=device),
        torch.full((n_sweeps,), dt, dtype=f32, device=device),
        torch.as_tensor(vs.astype(np.float32), device=device))
    ts = (torch.arange(period + 1, dtype=f32, device=device)
          * torch.tensor(dt, dtype=f32, device=device))
    return protos, ts, n_sweeps, period


def _rhs_markov(t, y, a):
    params, proto = a
    return markov_rhs(params, t, y, P.voltage(proto, t))


def generate_data(outdir=None, cached=False, device=None, recordings=None):
    """Markov ground truth on the recordings (per-protocol solve from rest,
    continuous across sweeps) + the full-resolution seed-0 noise stream,
    subsampled [::10].  Returns one float64 array per recording (d3 [57806],
    d5 [92902] for Pr3 and Pr5).  With ``outdir``, the data are kept in
    ``data.npz`` there and read back when ``cached``.  ``recordings``
    (default ``RECORDINGS``) may name stand-ins: a list of (name, per-sample
    voltage, dt, n_sweeps, period)."""
    cache = os.path.join(outdir, "data.npz") if outdir else None
    if cached and cache and os.path.exists(cache):
        with np.load(cache) as d:
            return tuple(d[f"d{k}"] for k in range(len(d.files)))
    device = resolve_device(device)
    parts = []
    for rec in recordings or RECORDINGS:
        protos, ts, n_sweeps, period = _sweep_protos(rec, device)
        y0 = torch.as_tensor(MARKOV_Y0_REST, device=device)
        ys = odeint_chained(_rhs_markov, y0, ts, protos, MARKOV_B06,
                            buffer_size=16384, max_steps=200_000)
        v = torch.stack([P.voltage(P.Protocol(t0, dt, vv), ts)
                         for t0, dt, vv in zip(*protos)])
        i = ys[:, :-1, -1] * (v[:, :-1] - float(SYNTHETIC.e))
        parts.append(i.cpu().numpy().astype(np.float64).reshape(-1))
    # the noise is drawn over the FULL-resolution concatenated trace, then
    # subsampled [::10]; the global lattice splits per protocol when every
    # protocol but the last has a multiple of 10 samples (Pr3 does)
    rs = np.random.RandomState(0)
    noise = rs.normal(0.0, NOISE_SIGMA, sum(p.size for p in parts))
    data, at = [], 0
    for k, part in enumerate(parts):
        if k < len(parts) - 1 and part.size % SUB:
            raise ValueError(f"recording {k} has {part.size} samples, not a "
                             f"multiple of {SUB}: the score lattice would "
                             f"not split per protocol")
        data.append((part + noise[at:at + part.size])[::SUB])
        at += part.size
    if cache:
        os.makedirs(outdir, exist_ok=True)
        np.savez(cache, **{f"d{k}": d for k, d in enumerate(data)})
    return tuple(data)


def _lattice_decomposition(n_sweeps: int, period: int):
    """Per-sweep view of the global [::SUB] lattice on the flat per-protocol
    axis (the score subsamples the CONCATENATED trace, so when
    period % SUB != 0 the lattice phase shifts across sweeps: Pr5).
    Returns (idx [n_sweeps, n_lat] local sample indices padded with repeats,
    mask [n_sweeps, n_lat] validity, counts [n_sweeps])."""
    n_lat = -(-period // SUB)
    idx = np.zeros((n_sweeps, n_lat), np.int64)
    msk = np.zeros((n_sweeps, n_lat), bool)
    counts = []
    for k in range(n_sweeps):
        j0 = (-k * period) % SUB
        jj = np.arange(j0, period, SUB)
        idx[k, :jj.size] = jj
        idx[k, jj.size:] = jj[-1] if jj.size else 0
        msk[k, :jj.size] = True
        counts.append(jj.size)
    if sum(counts) != len(range(0, n_sweeps * period, SUB)):
        raise AssertionError("the per-sweep lattice does not tile [::SUB]")
    return idx, msk, np.asarray(counts)


def make_objective_fused(d3: np.ndarray, d5: np.ndarray, pop: int,
                         trips: int = 2048, *, device=None, recordings=None):
    """The whole-trace SSE objective through the adaptive HH-population
    solve: one launch per sweep, per-lane y0 carry across sweeps and across
    the Pr3->Pr5 boundary; a generation's cost does not depend on the
    population size up to 128 lanes.  A stiff candidate is pace-culled and
    scores inf alone.  Returns objective(xs [n <= pop, 4] numpy) -> SSE [n]
    numpy float64; ``objective.device_fn`` is the same on tensors
    ([pop, 4] -> [pop]) on ``device``, eager.  On a CUDA device the first
    call of ``objective`` runs ``device_fn`` and captures it as a CUDA graph
    (``ops._build.Graph``); every later call copies the candidates in and
    replays the graph, bit for bit the same launches.  ``recordings`` as in
    ``generate_data``."""
    device = resolve_device(device)
    f32 = torch.float32
    blocks = []
    for rec, d in zip(recordings or RECORDINGS, (d3, d5)):
        protos, _ts, n_sweeps, period = _sweep_protos(rec, device)
        dt = float(protos.dt[0])
        idx, msk, counts = _lattice_decomposition(n_sweeps, period)
        splits = np.cumsum(counts)[:-1]
        d_rows = np.zeros(idx.shape, np.float32)
        for k, chunk in enumerate(np.split(np.asarray(d), splits)):
            d_rows[k, :chunk.size] = chunk
        idx_t = torch.as_tensor(idx, device=device)
        v_rows = torch.take_along_dim(protos.v, idx_t, dim=1)
        ts_lat = idx.astype(np.float32) * dt
        ts_aug = np.concatenate(
            [ts_lat, np.full((n_sweeps, 1), period * dt, np.float32)],
            axis=1)
        blocks.append((protos.v,
                       torch.as_tensor(ts_aug, device=device),
                       v_rows,
                       torch.as_tensor(d_rows, device=device),
                       torch.as_tensor(msk, device=device),
                       dt, float(period * dt)))

    rg = torch.tensor([float(x) for x in RGATE], dtype=f32, device=device)
    e_rev = float(SYNTHETIC.e)
    zero = torch.zeros((), dtype=f32, device=device)
    rest = torch.tensor([0.0, 1.0], dtype=f32, device=device).repeat(pop, 1)

    def sse_pop(xs: torch.Tensor) -> torch.Tensor:
        p8 = torch.cat([xs, rg[None].expand(pop, 4)], dim=1)
        y = rest
        acc = torch.zeros(pop, dtype=f32, device=device)
        for seg_v, ts_aug, v_rows, d_rows, msk, dt, t_endf in blocks:
            for k in range(seg_v.shape[0]):
                ys = fused_hh_pop_solve_ft(
                    p8, seg_v[k], ts_aug[k], proto_dt=dt, t_end=t_endf,
                    trips=trips, y0=y)
                i_sim = (ys[:, :-1, 0] * ys[:, :-1, 1]
                         * (v_rows[k][None] - e_rev))
                acc = acc + torch.sum(
                    torch.where(msk[k][None], (i_sim - d_rows[k][None]) ** 2,
                                zero), dim=1)
                y = ys[:, -1, :]
        return _inf_sentinel(acc)

    return _host_objective(sse_pop, pop, device, capture=True)


def _host_objective(sse_pop, pop: int, device, capture: bool):
    """objective(xs [n <= pop, 4] numpy) -> SSE [n] numpy float64 around
    ``sse_pop`` ([pop, 4] -> [pop] tensors on ``device``, also kept as
    ``objective.device_fn``); fewer members than pop are padded with the
    last one.  With ``capture`` on a CUDA device, the first call runs
    sse_pop eagerly and captures it as a CUDA graph (``ops._build.Graph``);
    every later call copies the candidates in and replays it."""
    graph = []

    def objective(xs: np.ndarray) -> np.ndarray:
        n = xs.shape[0]
        if n < pop:  # pad to the population width
            xs = np.concatenate([xs, np.repeat(xs[-1:], pop - n, axis=0)])
        xs = torch.as_tensor(np.asarray(xs, np.float32), device=device)
        if graph:
            graph[0].inputs[0].copy_(xs)
            out = graph[0].replay()
        else:
            out = sse_pop(xs)
            if capture and device.type == "cuda":
                graph.append(Graph(sse_pop, xs.clone()))
        return out.cpu().numpy().astype(np.float64)[:n]

    objective.device_fn = sse_pop
    return objective


def _rhs_hh_pop(t, y, args):
    """Population-batched candidate HH: per-lane p1-p4 (y [POP, 2])."""
    ps, proto = args
    v = P.voltage(proto, t)
    k1 = ps[:, 0] * torch.exp(ps[:, 1] * v)
    k2 = ps[:, 2] * torch.exp(-ps[:, 3] * v)
    k3 = float(RGATE[0]) * torch.exp(float(RGATE[1]) * v)
    k4 = float(RGATE[2]) * torch.exp(-float(RGATE[3]) * v)
    dadt = k1 * (1.0 - y[:, 0]) - k2 * y[:, 0]
    drdt = -k3 * y[:, 1] + k4 * (1.0 - y[:, 1])
    return torch.stack([dadt, drdt], dim=-1)


def _inf_sentinel(acc: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(acc), acc,
                       torch.full_like(acc, float("inf")))


def make_objective(d3: np.ndarray, d5: np.ndarray, pop: int, *, device=None,
                   recordings=None):
    """The default (lockstep) objective: the whole-population whole-trace
    SSE on the [::10] lattice, per sweep ONE adaptive batched-lane solve
    (``solver.odeint_batched``: rtol 1e-5, atol 1e-7, 8,192 records,
    200,000 steps), state chained across sweeps and across the Pr3->Pr5
    boundary.  Returns objective(xs [n <= pop, 4] numpy) -> SSE [n]
    (``objective.device_fn`` on tensors).  ``recordings`` as in
    ``generate_data``."""
    device = resolve_device(device)
    blocks = []
    for rec, d in zip(recordings or RECORDINGS, (d3, d5)):
        protos, ts, n_sweeps, period = _sweep_protos(rec, device)
        sweeps = [P.Protocol(t0, dt, vv) for t0, dt, vv in zip(*protos)]
        v = torch.stack([P.voltage(pr, ts) for pr in sweeps])
        blocks.append((sweeps, ts, v[:, :-1],
                       torch.as_tensor(np.asarray(d), dtype=torch.float32,
                                       device=device)))
    e_rev = float(SYNTHETIC.e)
    rest = torch.tensor([0.0, 1.0], dtype=torch.float32,
                        device=device).repeat(pop, 1)

    def sse_pop(xs: torch.Tensor) -> torch.Tensor:
        y = rest
        acc = torch.zeros(pop, dtype=torch.float32, device=device)
        for sweeps, ts, v, d in blocks:
            i_all = []
            for proto_k, v_row in zip(sweeps, v):
                ys = odeint_batched(_rhs_hh_pop, y, ts, (xs, proto_k),
                                    rtol=1e-5, atol=1e-7, buffer_size=8192,
                                    max_steps=200_000)
                i_all.append(ys[:, :-1, 0] * ys[:, :-1, 1]
                             * (v_row[None] - e_rev))
                y = ys[:, -1, :]
            # [pop, n_sweeps * period] -> the global [::10] lattice
            i_flat = torch.cat(i_all, dim=1)[:, ::SUB]
            acc = acc + torch.sum((i_flat - d[None]) ** 2, dim=1)
        return _inf_sentinel(acc)

    return _host_objective(sse_pop, pop, device, capture=False)


def make_objective_analytic(d3: np.ndarray, d5: np.ndarray, pop: int,
                            ramp_subdiv: int = 4, *, device=None,
                            recordings=None):
    """--analytic: the same whole-trace SSE through the EXACT piecewise-
    constant propagator (``hh_solve_analytic_seg``): the HH candidate is
    linear within each constant-voltage segment of the step protocols, so
    each sweep is a composition over its segments' closed-form affine maps
    plus one expm1 per knot, no ODE solve.  The only non-finite escape is a
    wild candidate overflowing its f32 rate, caught by the inf sentinel.  On
    a CUDA device the first call captures the generation as one CUDA graph,
    later calls replay it; ``objective.device_fn`` is the eager [pop, 4] ->
    [pop] function (captured by ``cmaes_onchip``)."""
    device = resolve_device(device)
    blocks = []
    for rec, d in zip(recordings or RECORDINGS, (d3, d5)):
        protos, _ts, n_sweeps, period = _sweep_protos(rec, device)
        blocks.append((protos.v, float(protos.dt[0]),
                       torch.as_tensor(np.asarray(d), dtype=torch.float32,
                                       device=device),
                       hh_segments(protos.v)))
    for *_, seg in blocks:
        seg.tensors(device)          # uploaded before any capture
    f32 = torch.float32
    rg = torch.tensor([float(x) for x in RGATE], dtype=f32, device=device)
    e_rev = float(SYNTHETIC.e)
    rest = torch.tensor([0.0, 1.0], dtype=f32, device=device).repeat(pop, 1)

    def sse_pop(xs: torch.Tensor) -> torch.Tensor:
        p8 = torch.cat([xs, rg[None].expand(pop, 4)], dim=1)
        y = rest
        acc = torch.zeros(pop, dtype=f32, device=device)
        for vs, dt, d, seg in blocks:
            i_all = []
            for v_row in vs:
                ys = hh_solve_analytic_seg(p8, v_row, dt, y0=y, seg=seg,
                                           ramp_subdiv=ramp_subdiv)
                i_all.append(ys[:, :-1, 0] * ys[:, :-1, 1]
                             * (v_row[None, :-1] - e_rev))
                y = ys[:, -1, :]
            i_flat = torch.cat(i_all, dim=1)[:, ::SUB]
            acc = acc + torch.sum((i_flat - d[None]) ** 2, dim=1)
        return _inf_sentinel(acc)

    return _host_objective(sse_pop, pop, device, capture=True)


def make_objective_native(d3: np.ndarray, d5: np.ndarray, *,
                          recordings=None):
    """--myokit: the same whole-trace SSE through the native C++ host solver
    (``ionflux_torch.native.csolve``: rtol 1e-5, atol 1e-7, its watchdog's
    inf sentinel), one member and one sweep at a time on the host, in
    float64.  Returns objective(xs [n, 4] numpy) -> SSE [n]."""
    from ionflux_torch.native import csolve

    blocks = []
    for rec, d in zip(recordings or RECORDINGS, (d3, d5)):
        _, v, dt, n_sweeps, period = _recording(rec)
        v = np.asarray(v)
        vs = np.empty((n_sweeps, period + 1), np.float64)
        vs[:, :period] = v.reshape(n_sweeps, period)
        vs[:-1, period] = vs[1:, 0]
        vs[-1, period] = vs[-1, period - 1]
        ts = np.arange(period + 1, dtype=np.float64) * float(dt)
        blocks.append((vs, ts, float(dt), np.asarray(d, np.float64)))
    e_rev = float(SYNTHETIC.e)

    def one(x: np.ndarray) -> float:
        params = np.concatenate([x, np.asarray(RGATE, np.float64)])
        acc = 0.0
        for vs, ts, dt, d in blocks:
            y0 = np.array([0.0, 1.0])
            rows = []
            for k in range(vs.shape[0]):
                ys = csolve("hh", params, 0.0, dt, vs[k], ts, y0=y0,
                            rtol=1e-5, atol=1e-7, timeout_s=60.0)
                if not np.all(np.isfinite(ys)):
                    return float("inf")
                rows.append(ys[:-1, 0] * ys[:-1, 1] * (vs[k][:-1] - e_rev))
                y0 = ys[-1]
            i_flat = np.concatenate(rows)[::SUB]
            acc += float(np.sum((i_flat - d) ** 2))
        return acc

    def objective(xs: np.ndarray) -> np.ndarray:
        return np.array([one(x) for x in np.asarray(xs, np.float64)])

    return objective


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="IKr syn. discrepancy fit with HH candidate (d0), on "
                    "the ionflux_torch port.")
    parser.add_argument("--outdir", type=str, default=None,
                        help="where data.npz and model-parameters.txt go "
                             "(default out/d0-torch)")
    parser.add_argument("--cached", action="store_true",
                        help="reuse <outdir>/data.npz if it is there")
    parser.add_argument("--debug", action="store_true",
                        help="stop after the initial guess's error")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--max-iterations", type=int, default=None,
                        help="stop CMA-ES after this many generations")
    parser.add_argument("--myokit", action="store_true",
                        help="the objective through the native C++ host "
                             "solver (ionflux_torch.native.csolve), one "
                             "member at a time")
    parser.add_argument("--fused", action="store_true",
                        help="the objective through the adaptive "
                             "HH-population kernel, one launch per sweep")
    parser.add_argument("--analytic", action="store_true",
                        help="the objective through the exact piecewise-"
                             "constant propagator (no ODE solve)")
    parser.add_argument("--onchip", action="store_true",
                        help="run the whole CMA-ES fit device-resident "
                             "(fit.cmaes.cmaes_onchip) over the --analytic "
                             "(default) or --fused objective")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    outdir = args.outdir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "out", "d0-torch")

    t = time.perf_counter()
    d3, d5 = generate_data(outdir, args.cached, device)
    print(f"data: {d3.size} + {d5.size} points on {device} in "
          f"{time.perf_counter() - t:.1f} s")

    pop = _default_popsize(len(P0))
    if args.myokit:
        print("--myokit: objective through the native C++ host solver")
        objective = make_objective_native(d3, d5)
    elif args.fused:
        print("--fused: objective through the adaptive HH-population "
              "kernel")
        objective = make_objective_fused(d3, d5, pop, device=device)
    elif args.analytic or args.onchip:
        print("--analytic: objective through the exact piecewise-constant "
              "propagator (no ODE solve)")
        objective = make_objective_analytic(d3, d5, pop, device=device)
    else:
        print("objective through the lockstep batched-lane solve")
        objective = make_objective(d3, d5, pop, device=device)
    launches = fused_hh_pop_solve_ft.launches
    f0 = objective(P0[None])[0]
    print("Initial guess error:", f0)
    if args.fused:
        print("kernel launches per evaluation:",
              fused_hh_pop_solve_ft.launches - launches)
    if args.debug:
        return 0

    t = time.perf_counter()
    if args.onchip:
        if args.myokit:
            raise SystemExit("--onchip needs a device objective: --analytic "
                             "or --fused, not --myokit")
        print("--onchip: device-resident CMA-ES (chunks of generations, "
              "one host read a chunk)")
        res = cmaes_onchip(
            objective.device_fn, P0, sigma0=P0 * 0.1,
            bounds=(P0 * 0.1, P0 * 10.0),
            max_iterations=args.max_iterations, max_unchanged_iterations=100,
            unchanged_threshold=1e-3, device=device,
        )
    else:
        res = cmaes(
            objective, P0, sigma0=P0 * 0.1, bounds=(P0 * 0.1, P0 * 10.0),
            max_iterations=args.max_iterations, max_unchanged_iterations=100,
            unchanged_threshold=1e-3, verbose=True,
        )
    secs = time.perf_counter() - t
    print(f"CMA-ES done: {res.iterations} iters, {res.evaluations} evals, "
          f"best SSE {res.fx:.6f}, {secs / res.iterations:.3f} s per "
          f"generation"
          + (" (stopped at --max-iterations)" if res.hit_max_iterations
             else ""))
    print("found parameters:", res.x)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "model-parameters.txt"), "w") as fh:
        for v in res.x:
            fh.write(f"{v:.18e}\n")
    print("reference d0 fit:   ", REF_D0)
    print("ratio found/ref:    ", res.x / REF_D0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
