#!/usr/bin/env python
"""Time the d0 fit of one checkout of ``ionflux_torch`` on the card: its
kernels, its four objectives and its two CMA-ES loops (the port's
counterpart of ``scripts/measure_d0_objectives.py`` and
``scripts/measure_onchip_cmaes.py``).

    python3 scripts/time_fit_torch.py [--root DIR] [--reps 20]
        [--objectives lockstep,analytic,fused,native]

``--root`` names the checkout whose ``ionflux_torch`` and
``scripts/train_d0_torch.py`` are timed (default: this one); its kernels are
built there at first use.  The protocols and chip_smoke.py's helpers come
from this checkout.

- kernels, at chip_smoke.py's (i) and (j) shapes: B3
  (``fused_hh_pop_solve_ft``) at 128 lanes (HH_B06 x exp(0.1 N(0, 1)),
  ``RandomState(0)``) and at 8 (the first 8) on Pr3 sweep 0 (82,581 knots),
  rtol 1e-5, 2048 trips: ms (CUDA events, mean of ``--reps`` launches after
  51 more), executed trips, ms per executed trip and a SHA-256 of the
  executed records (equal hashes: identical records); B5 (``fused_hh_rk4``)
  at 128 lanes on the same sweep, 10 substeps per 1 ms output: ms, us per
  substep and the trace's SHA-256;
- objectives, on ``generate_data``'s data: each of ``--objectives`` at
  populations 8, 64 and 128: seconds per generation on the host clock (each
  call ends in the host copy of the SSE), the median of 5 generations after
  a first one (each generation P0 x exp(0.1 N(0, 1)), numpy
  ``default_rng(0)``), and at 8 the device's busy time in a profiler trace
  of one more generation, so its idle share; the native objective at 8 only
  (one member at a time on the host);
- fits (with any objective): the full d0 fit over the analytic objective by
  the host loop (``fit.cmaes.cmaes``) and by ``fit.cmaes.cmaes_onchip``
  (JAX's settings): generations, wall seconds, seconds per generation and
  found / reference parameters.

Prints one JSON line with the checkout, the card's name and power limit.
Run parent, change, change, parent in one call to compare.  Without a card
it exits with an error.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sha(tensors) -> str:
    digest = hashlib.sha256()
    for x in tensors:
        digest.update(x.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def _busy_ms(fn) -> float:
    """Device time (ms) of one call of fn in a profiler trace; 0 if the
    trace holds none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / 1e3


SPIN = 50   # B3 launches before its timing


POPS = (8, 64, 128)


def main(root: str, reps: int, objectives=()) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("time_fit_torch: no CUDA device")
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "scripts"))
    sys.path.insert(0, root)
    C = _chip_smoke()
    import train_d0_torch as T
    from ionflux_torch.models.registry import HH_B06
    from ionflux_torch.ops import hh_solve as H

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    protos3, _, _, period3 = T._sweep_protos(T.RECORDINGS[0], dev)
    dt = float(protos3.dt[0])
    v3 = protos3.v[0]
    base = np.array([float(x) for x in HH_B06])
    pop128 = torch.tensor(
        base[None] * np.exp(0.1 * np.random.RandomState(0).randn(128, 8)),
        dtype=f32, device=dev)

    kernels = {}
    for name, params in (("B3 128 lanes", pop128), ("B3 8 lanes",
                                                    pop128[:8].contiguous())):
        kw = dict(proto_t0=0.0, proto_dt=dt, t_end=period3 * dt, rtol=1e-5,
                  atol=1e-7, trips=C.HH_TRIPS)
        call = lambda p=params: H._hh_pop_solve(p, v3, None, plain=False,
                                                **kw)
        for _ in range(SPIN):   # the card's clocks up before timing
            call()
        ms, out = C.cuda_ms(call, reps)
        n_valid = int(out[3][1])
        kernels[name] = {
            "ms": ms, "n_acc": int(out[3][0]), "n_valid": n_valid,
            "ms_per_trip": ms / n_valid,
            "records_sha256": _sha([r[:n_valid] for r in out[:3]]
                                   + [out[3], out[4]])}
    n_out = period3 // 10 + 1
    substeps = (n_out - 1) * 10
    ms, ys = C.cuda_ms(lambda: H.fused_hh_rk4(
        pop128, v3, proto_dt=dt, dt_out=1.0, n_out=n_out, n_sub=10),
        max(1, reps // 4))
    kernels["B5 128 lanes"] = {"ms": ms, "substeps": substeps,
                               "us_per_substep": ms * 1e3 / substeps,
                               "trace_sha256": _sha([ys])}

    out = {"root": root, "card": C.device_line(), "kernels": kernels}
    if objectives:
        d3, d5 = T.generate_data(device=dev)
        out["objectives"] = _objectives(T, d3, d5, dev, objectives)
        out["fits"] = _fits(T, d3, d5, dev)
    print(json.dumps(out), flush=True)
    return out


def _objectives(T, d3, d5, dev, names) -> dict:
    """Seconds per generation of each objective at each population: the
    median of 5 generations after a first one."""
    rng = np.random.default_rng(0)
    make = {"lockstep": lambda p: T.make_objective(d3, d5, p, device=dev),
            "analytic": lambda p: T.make_objective_analytic(d3, d5, p,
                                                            device=dev),
            "fused": lambda p: T.make_objective_fused(d3, d5, p, device=dev),
            "native": lambda p: T.make_objective_native(d3, d5)}
    out = {}
    for name in names:
        for pop in (8,) if name == "native" else POPS:
            obj = make[name](pop)
            times = []
            for k in range(6):
                xs = T.P0[None] * np.exp(rng.normal(0.0, 0.1, (pop, 4)))
                t = time.perf_counter()
                f = obj(xs)
                times.append(time.perf_counter() - t)
            med = float(np.median(times[1:]))
            row = {"s_per_generation": med, "first_s": times[0],
                   "finite": int(np.isfinite(f).sum())}
            if name != "native" and pop == 8:
                busy = _busy_ms(lambda: obj(xs))
                row["device_busy_ms"] = busy
                row["idle_share"] = (1.0 - busy / (med * 1e3) if busy > 0
                                     else None)
            out[f"{name} {pop}"] = row
    return out


def _fits(T, d3, d5, dev) -> dict:
    """The full d0 fit over the analytic objective, by the host loop and
    device-resident."""
    from ionflux_torch.fit.cmaes import cmaes, cmaes_onchip

    pop = 8
    obj = T.make_objective_analytic(d3, d5, pop, device=dev)
    obj(T.P0[None])
    kw = dict(sigma0=T.P0 * 0.1, bounds=(T.P0 * 0.1, T.P0 * 10.0),
              max_unchanged_iterations=100, unchanged_threshold=1e-3)
    out = {}
    for name, run in (
            ("host cmaes", lambda: cmaes(obj, T.P0, **kw)),
            ("cmaes_onchip", lambda: cmaes_onchip(obj.device_fn, T.P0,
                                                  device=dev, **kw))):
        t = time.perf_counter()
        res = run()
        secs = time.perf_counter() - t
        out[name] = {"generations": res.iterations, "wall_s": secs,
                     "s_per_generation": secs / res.iterations,
                     "best_sse": res.fx,
                     "found_over_reference": (res.x / T.REF_D0).tolist()}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose ionflux_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--objectives",
                    default="lockstep,analytic,fused,native",
                    help="comma-separated; empty: the kernels only (no "
                         "objective, no fit)")
    args = ap.parse_args()
    main(args.root, args.reps, [x for x in args.objectives.split(",") if x])
