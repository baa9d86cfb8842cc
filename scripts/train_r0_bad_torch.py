#!/usr/bin/env python
"""Study r0-bad on the ionflux_torch port: CMA-ES fit of the candidate HH
a-gate (p1-p4) to the real cell-5 Pr3+Pr4 currents, the real-data sibling
of ``train_d0_torch.py`` and the paper's "insufficient protocols" negative
control (figures 6 and 7).

    python3 scripts/train_r0_bad_torch.py [--myokit | --fused | --analytic]
                                          [--onchip] [--max-iterations N]

The PyTorch / CUDA counterpart of ``scripts/train_r0_bad.py``.  The
measured currents at the capacitance-masked samples are recovered from the
reference's ``r1-bad`` surface cache (``realdata.recover_measurements``,
``IONFLUX_REFERENCE/r1-bad``); the model is one continuous Pr3+Pr4 trace
(state carried across all 23 sweeps), g = 0.1524, E = -86 mV, the rounded
r-gate; p0 is the B06 a-gate, sigma0 = 0.1 p0, bounds [0.1 p0, 10 p0],
log-transform, stop after 100 unchanged generations at 1e-3.  The objective
is the SSE on that masked lattice, by one of the JAX driver's paths, chosen
by its flags in its order:

- no flag: the lockstep objective, one batched-lane adaptive solve per sweep
  (``solver.odeint_batched``);
- ``--myokit``: the native C++ host solver, one member at a time;
- ``--fused``: one launch of the adaptive HH-population kernel
  (``ops/hh_solve.fused_hh_pop_solve_ft``, B3) per sweep, 23 in all, each
  on the sweep's own lattice padded to the longest (repeats of its last
  time, then a validity mask) with ``t_end`` last; on the card a generation
  is one replay of a CUDA graph of those launches and the SSE;
- ``--analytic``: the exact piecewise-constant propagator, no ODE solve;
- ``--onchip``: the whole fit device-resident (``fit.cmaes.cmaes_onchip``,
  its eigensolver K2) over the analytic objective, or the fused one with
  ``--fused``.

Runs on the card unless ``--device cpu`` is given; writes data.png (where
matplotlib is installed), model-parameters.txt and report.json to --outdir
(default out/r0-bad-torch).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import outdir, parse, study_parser, traced  # noqa: E402
from train_d0_torch import (  # noqa: E402
    _host_objective,
    _inf_sentinel,
    _sweep_protos,
)

from ionflux_torch import protocols as P  # noqa: E402
from ionflux_torch import protorec  # noqa: E402
from ionflux_torch._device import resolve_device  # noqa: E402
from ionflux_torch.fit.cmaes import (  # noqa: E402
    _default_popsize,
    cmaes,
    cmaes_onchip,
)
from ionflux_torch.models.registry import (  # noqa: E402
    CELL5_R1BAD,
    HH_B06,
    HH_R1BAD_INIT,
    R1BAD_RGATE,
)
from ionflux_torch.ops.hh_solve import fused_hh_pop_solve_ft  # noqa: E402
from ionflux_torch.realdata import recover_measurements  # noqa: E402
from ionflux_torch.rstudies import refdir  # noqa: E402
from ionflux_torch.solver import odeint_batched  # noqa: E402
from ionflux_torch.solver.analytic import (  # noqa: E402
    hh_segments,
    hh_solve_analytic_seg,
)

# initial guess: the B06 staircase-ramp a-gate (train-r0-bad.py:32-38)
P0 = np.array([float(HH_B06.p1), float(HH_B06.p2),
               float(HH_B06.p3), float(HH_B06.p4)])
G = 0.1524          # fixed conductance (train-r0-bad.py:365)
E = -86.0           # g*a*r*(V+86) (train-r0-bad.py:373)
RGATE = tuple(float(x) for x in R1BAD_RGATE)  # rounded (ODEFunc:159-162)
NAMES = ("pr3", "pr4")
# the reference r0-bad fit (r0-bad/model-parameters.txt)
REF_R0BAD = np.array([1.907386659660279861e-04, 4.884512388490065693e-02,
                      1.331886974861103986e-05, 6.220652138222864530e-02])


def _rhs_hh_pop(t, y, args):
    """Population-batched candidate HH: per-lane p1-p4, fixed r-gate."""
    ps, proto = args
    v = P.voltage(proto, t)
    k1 = ps[:, 0] * torch.exp(ps[:, 1] * v)
    k2 = ps[:, 2] * torch.exp(-ps[:, 3] * v)
    k3 = RGATE[0] * torch.exp(RGATE[1] * v)
    k4 = RGATE[2] * torch.exp(-RGATE[3] * v)
    dadt = k1 * (1.0 - y[:, 0]) - k2 * y[:, 0]
    drdt = -k3 * y[:, 1] + k4 * (1.0 - y[:, 1])
    return torch.stack([dadt, drdt], dim=-1)


def _lattice(meas: dict, name: str):
    """(sample indices into the whole recording, measured current f32) of
    one protocol's lattice."""
    tl, i_meas = meas[name]
    idx = np.round(np.asarray(tl) / protorec.DT_MS).astype(np.int64)
    return idx, np.asarray(i_meas, np.float32)


def _rest(pop: int, device) -> torch.Tensor:
    return torch.tensor([0.0, 1.0], dtype=torch.float32,
                        device=device).repeat(pop, 1)


def make_objective(meas: dict, pop: int, *, device=None):
    """The default (lockstep) objective: the whole-population SSE on the
    concatenated Pr3+Pr4 masked lattice, per sweep ONE adaptive batched-lane
    solve (rtol 1e-5, atol 1e-7, 8,192 records, 200,000 steps), state
    chained across sweeps AND across the Pr3->Pr4 boundary.  Returns
    objective(xs [n <= pop, 4] numpy) -> SSE [n] (``objective.device_fn``
    on tensors)."""
    device = resolve_device(device)
    blocks = []
    for name in NAMES:
        protos, ts, n_sweeps, period = _sweep_protos(f"{name}-cell5", device)
        sweeps = [P.Protocol(t0, dt, vv) for t0, dt, vv in zip(*protos)]
        idx, d = _lattice(meas, name)
        v_lat = protorec.load_voltage(f"{name}-cell5")[0][idx]
        blocks.append((sweeps, ts, *(torch.as_tensor(x, device=device) for x
                                     in (v_lat.astype(np.float32), idx, d))))

    rest = _rest(pop, device)

    def sse_pop(xs: torch.Tensor) -> torch.Tensor:
        y = rest
        acc = torch.zeros(pop, dtype=torch.float32, device=device)
        for sweeps, ts, v_lat, idx, d in blocks:
            parts = []
            for proto_k in sweeps:
                ys = odeint_batched(_rhs_hh_pop, y, ts, (xs, proto_k),
                                    rtol=1e-5, atol=1e-7, buffer_size=8192,
                                    max_steps=200_000)
                parts.append(ys[:, :-1, :])
                y = ys[:, -1, :]
            ys = torch.cat(parts, dim=1)[:, idx]        # [pop, n_lat, 2]
            i_sim = G * ys[:, :, 0] * ys[:, :, 1] * (v_lat[None] - E)
            acc = acc + torch.sum((i_sim - d[None]) ** 2, dim=1)
        return _inf_sentinel(acc)

    return _host_objective(sse_pop, pop, device, capture=False)


def make_objective_analytic(meas: dict, pop: int, ramp_subdiv: int = 4, *,
                            device=None):
    """--analytic: the masked-lattice SSE through the EXACT piecewise-
    constant propagator (``hh_solve_analytic_seg``): each sweep a
    composition over its segments' closed-form affine maps plus one expm1
    per knot, no ODE solve.  On a CUDA device the first call captures the
    generation as one CUDA graph, later calls replay it;
    ``objective.device_fn`` is the eager [pop, 4] -> [pop] function
    (captured by ``cmaes_onchip``)."""
    device = resolve_device(device)
    blocks = []
    for name in NAMES:
        protos, _ts, n_sweeps, period = _sweep_protos(f"{name}-cell5", device)
        idx, d = _lattice(meas, name)
        v_lat = protorec.load_voltage(f"{name}-cell5")[0][idx]
        blocks.append((protos.v, float(protos.dt[0]),
                       *(torch.as_tensor(x, device=device) for x in
                         (v_lat.astype(np.float32), idx, d)),
                       hh_segments(protos.v)))
    for *_, seg in blocks:
        seg.tensors(device)          # uploaded before any capture
    f32 = torch.float32
    rg = torch.tensor(RGATE, dtype=f32, device=device)
    rest = _rest(pop, device)    # made before any capture

    def sse_pop(xs: torch.Tensor) -> torch.Tensor:
        p8 = torch.cat([xs, rg[None].expand(pop, 4)], dim=1)
        y = rest
        acc = torch.zeros(pop, dtype=f32, device=device)
        for vs, dt, v_lat, idx, d, seg in blocks:
            parts = []
            for v_row in vs:
                ys = hh_solve_analytic_seg(p8, v_row, dt, y0=y, seg=seg,
                                           ramp_subdiv=ramp_subdiv)
                parts.append(ys[:, :-1, :])
                y = ys[:, -1, :]
            ys = torch.cat(parts, dim=1)[:, idx]
            i_sim = G * ys[:, :, 0] * ys[:, :, 1] * (v_lat[None] - E)
            acc = acc + torch.sum((i_sim - d[None]) ** 2, dim=1)
        return _inf_sentinel(acc)

    return _host_objective(sse_pop, pop, device, capture=True)


def _fused_lattice(idx: np.ndarray, d: np.ndarray, v_full: np.ndarray,
                   n_sweeps: int, period: int, dt: float):
    """Per-sweep view of a protocol's masked lattice for the fused solve:
    local output times padded to the longest sweep's count by repeats of the
    sweep's last time, ``period * dt`` (t_end) as a last column; the
    voltages, data and validity mask on the same [n_sweeps, n_lat] grid."""
    locs, drs, vrs = [], [], []
    for k in range(n_sweeps):
        sel = (idx >= k * period) & (idx < (k + 1) * period)
        locs.append(idx[sel] - k * period)
        drs.append(d[sel])
        vrs.append(v_full[idx[sel]])
    n_lat = max(loc.size for loc in locs)
    loc_p = np.zeros((n_sweeps, n_lat), np.int64)
    d_p = np.zeros((n_sweeps, n_lat), np.float32)
    v_p = np.zeros((n_sweeps, n_lat), np.float32)
    m_p = np.zeros((n_sweeps, n_lat), bool)
    for k in range(n_sweeps):
        n_k = locs[k].size
        loc_p[k, :n_k] = locs[k]
        loc_p[k, n_k:] = locs[k][-1] if n_k else 0
        d_p[k, :n_k] = drs[k]
        v_p[k, :n_k] = vrs[k]
        m_p[k, :n_k] = True
    ts_aug = np.concatenate(
        [loc_p.astype(np.float32) * dt,
         np.full((n_sweeps, 1), period * dt, np.float32)], axis=1)
    return ts_aug, v_p, d_p, m_p


def make_objective_fused(meas: dict, pop: int, trips: int = 2048, *,
                         device=None):
    """--fused: the masked-lattice SSE through the adaptive HH-population
    solve (B3), one launch per sweep (7 on Pr3, 16 on Pr4) with per-lane y0
    carry across sweeps and across the Pr3->Pr4 boundary, each on its
    sweep's lattice (``_fused_lattice``).  A stiff candidate is pace-culled
    and scores inf alone.  On a CUDA device the first call of ``objective``
    runs ``device_fn`` and captures it as a CUDA graph; every later call
    copies the candidates in and replays it."""
    device = resolve_device(device)
    blocks = []
    for name in NAMES:
        protos, _ts, n_sweeps, period = _sweep_protos(f"{name}-cell5", device)
        dt = float(protos.dt[0])
        idx, d = _lattice(meas, name)
        v_full = protorec.load_voltage(f"{name}-cell5")[0]
        ts_aug, v_p, d_p, m_p = _fused_lattice(idx, d, v_full, n_sweeps,
                                               period, dt)
        blocks.append((protos.v, *(torch.as_tensor(x, device=device)
                                   for x in (ts_aug, v_p, d_p, m_p)),
                       dt, float(period * dt)))
    f32 = torch.float32
    rg = torch.tensor(RGATE, dtype=f32, device=device)
    zero = torch.zeros((), dtype=f32, device=device)
    rest = _rest(pop, device)    # made before any capture

    def sse_pop(xs: torch.Tensor) -> torch.Tensor:
        p8 = torch.cat([xs, rg[None].expand(pop, 4)], dim=1)
        y = rest
        acc = torch.zeros(pop, dtype=f32, device=device)
        for seg_v, ts_aug, v_rows, d_rows, msk, dt, t_endf in blocks:
            for k in range(seg_v.shape[0]):
                ys = fused_hh_pop_solve_ft(
                    p8, seg_v[k], ts_aug[k], proto_dt=dt, t_end=t_endf,
                    trips=trips, y0=y)
                i_sim = (G * ys[:, :-1, 0] * ys[:, :-1, 1]
                         * (v_rows[k][None] - E))
                acc = acc + torch.sum(
                    torch.where(msk[k][None], (i_sim - d_rows[k][None]) ** 2,
                                zero), dim=1)
                y = ys[:, -1, :]
        return _inf_sentinel(acc)

    return _host_objective(sse_pop, pop, device, capture=True)


def make_objective_native(meas: dict):
    """--myokit: the same masked-lattice SSE through the native C++ host
    solver (``ionflux_torch.native.csolve``: rtol 1e-5, atol 1e-7, its
    watchdog's inf sentinel), one member and one sweep at a time on the
    host, in float64."""
    from ionflux_torch.native import csolve

    blocks = []
    for name in NAMES:
        n_sweeps, period = protorec.SWEEPS[f"{name}-cell5"]
        v, dt = protorec.load_voltage(f"{name}-cell5")
        vs = np.empty((n_sweeps, period + 1), np.float64)
        vs[:, :period] = v.reshape(n_sweeps, period)
        vs[:-1, period] = vs[1:, 0]
        vs[-1, period] = vs[-1, period - 1]
        ts = np.arange(period + 1, dtype=np.float64) * float(dt)
        tl, i_meas = meas[name]
        idx = np.round(np.asarray(tl) / protorec.DT_MS).astype(np.int64)
        blocks.append((vs, ts, float(dt), np.asarray(v, np.float64), idx,
                       np.asarray(i_meas, np.float64)))

    def one(x: np.ndarray) -> float:
        params = np.concatenate([x, np.asarray(RGATE, np.float64)])
        acc = 0.0
        for vs, ts, dt, v_full, idx, d in blocks:
            # each protocol from rest, as the JAX driver's native path does
            # (its other paths carry the state into Pr4)
            y0 = np.array([0.0, 1.0])
            rows = []
            for k in range(vs.shape[0]):
                ys = csolve("hh", params, 0.0, dt, vs[k], ts, y0=y0,
                            rtol=1e-5, atol=1e-7, timeout_s=60.0)
                if not np.all(np.isfinite(ys)):
                    return float("inf")
                rows.append(ys[:-1])
                y0 = ys[-1]
            yflat = np.concatenate(rows, axis=0)
            i_sim = G * yflat[:, 0] * yflat[:, 1] * (v_full - E)
            acc += float(np.sum((i_sim[idx] - d) ** 2))
        return acc

    def objective(xs: np.ndarray) -> np.ndarray:
        return np.array([one(x) for x in np.asarray(xs, np.float64)])

    return objective


def _simulate_fit(x: np.ndarray, name: str, *, device=None) -> np.ndarray:
    """Full-trace current (numpy f64) for one parameter vector on one
    protocol ("pr3" or "pr4"), by the lockstep solve from rest."""
    device = resolve_device(device)
    protos, ts, n_sweeps, period = _sweep_protos(f"{name}-cell5", device)
    xs = torch.as_tensor(np.tile(np.asarray(x, np.float32), (2, 1)),
                         device=device)
    y = _rest(2, device)
    parts = []
    for t0, dt, vv in zip(*protos):
        ys = odeint_batched(_rhs_hh_pop, y, ts, (xs, P.Protocol(t0, dt, vv)),
                            rtol=1e-5, atol=1e-7, buffer_size=8192,
                            max_steps=200_000)
        parts.append(ys[:, :-1, :])
        y = ys[:, -1, :]
    ys = torch.cat(parts, dim=1)
    v = torch.as_tensor(
        protorec.load_voltage(f"{name}-cell5")[0].astype(np.float32),
        device=device)
    i = G * ys[:, :, 0] * ys[:, :, 1] * (v[None] - E)
    return i[0].double().cpu().numpy()


def _draw_data(meas: dict, out: str, device) -> None:
    """The measurement against the initial guess (data.png), where
    matplotlib is installed."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: data.png not drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    for ax, name in zip(axes, NAMES):
        tl, i_meas = meas[name]
        i0 = _simulate_fit(P0, name, device=device)
        idx = np.round(np.asarray(tl) / protorec.DT_MS).astype(np.int64)
        ax.plot(np.asarray(tl) * 1e-3, i_meas, lw=0.5,
                label="recovered measurement")
        ax.plot(np.asarray(tl) * 1e-3, i0[idx], lw=0.5,
                label="initial guess")
        ax.set_ylabel(f"{name} current (nA)")
        ax.legend(loc="upper right", fontsize=8)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(os.path.join(out, "data.png"), dpi=150)
    plt.close(fig)
    print(f"wrote {out}/data.png")


def main(argv=None):
    """Parse the flags, recover the measurements, run the fit; returns the
    report (the dict written to report.json), or None with --debug."""
    parser = study_parser("IKr real-data candidate fit (r0-bad), on the "
                          "ionflux_torch port.", real=True)
    parser.add_argument("--myokit", action="store_true",
                        help="the objective through the native C++ host "
                             "solver, one member at a time")
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
    parser.add_argument("--max-iterations", type=int, default=None,
                        help="stop CMA-ES after this many generations")
    args = parse(parser, argv)
    device = resolve_device(args.device)
    out = outdir(args, "r0-bad-torch")
    with traced(args, out):
        return _fit(args, out, device)


def _fit(args, out: str, device):
    meas = recover_measurements(f"{refdir()}/r1-bad", CELL5_R1BAD,
                                HH_R1BAD_INIT, protocols=NAMES,
                                n_points=30, device=device)
    pop = _default_popsize(len(P0))  # CMA-ES default population
    if args.myokit:
        print("--myokit: objective through the native C++ host solver")
        objective = make_objective_native(meas)
    elif args.fused:
        print("--fused: objective through the adaptive HH-population "
              "kernel")
        objective = make_objective_fused(meas, pop, device=device)
    elif args.analytic or args.onchip:
        print("--analytic: objective through the exact piecewise-constant "
              "propagator (no ODE solve)")
        objective = make_objective_analytic(meas, pop, device=device)
    else:
        print("objective through the lockstep batched-lane solve")
        objective = make_objective(meas, pop, device=device)
    launches = fused_hh_pop_solve_ft.launches
    f0 = objective(P0[None])[0]
    print("Initial guess error:", f0)
    if args.fused:
        print("kernel launches per evaluation:",
              fused_hh_pop_solve_ft.launches - launches)
    _draw_data(meas, out, device)
    if args.debug:
        return None

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
          f"best SSE {res.fx:.6f}, {secs:.2f} s"
          + (" (stopped at --max-iterations)" if res.hit_max_iterations
             else ""))
    print("found parameters:", res.x)
    with open(os.path.join(out, "model-parameters.txt"), "w") as fh:
        for v in res.x:
            fh.write(f"{v:.18e}\n")
    print("reference r0-bad fit:", REF_R0BAD)
    print("ratio found/ref:     ", res.x / REF_R0BAD)
    # r0-bad is unidentifiable by design: wide parameter regions are
    # SSE-equivalent, so compare the objective at both parameter sets
    sse_ref, sse_ours = objective(np.stack([REF_R0BAD, res.x]))[:2]
    print(f"objective(archived fit) = {sse_ref:.1f}  "
          f"objective(our fit) = {sse_ours:.1f}")
    report = {"found": list(map(float, res.x)),
              "reference": list(map(float, REF_R0BAD)),
              "sse_found": float(sse_ours),
              "sse_reference_params": float(sse_ref),
              "iterations": res.iterations, "seconds": secs}
    with open(os.path.join(out, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
