#!/usr/bin/env python
"""Time the d0 fit path of one checkout of ``ionflux_torch`` on the card, to
compare two commits inside one run.

    python3 scripts/time_fit_torch.py [--root DIR] [--reps 20] [--gens 20]

``--root`` names the checkout whose ``ionflux_torch`` and
``scripts/train_d0_torch.py`` are timed (default: this one); its kernels are
built there at first use.  The protocols and chip_smoke.py's helpers come
from this checkout.  The shapes are chip_smoke.py's (i), (j) and (h):

- B3 (``fused_hh_pop_solve_ft``) at 128 lanes (HH_B06 x exp(0.1 N(0, 1)),
  ``RandomState(0)``) and at 8 (the first 8 of them) on Pr3 sweep 0 (82,581
  knots), rtol 1e-5, 2048 trips: ms (CUDA events, mean of ``--reps``
  launches after 51 more), executed trips (``n_valid``), ms per executed
  trip and a SHA-256 of the executed records, the outcome and the lane
  flags (equal hashes: identical records);
- B5 (``fused_hh_rk4``) at 128 lanes on the same sweep, 10 substeps per 1 ms
  output (82,580 substeps): ms (mean of ``--reps`` / 4 launches after a
  warm-up), us per substep and the trace's SHA-256;
- the d0 objective at the CMA-ES population of 8 on the recorded Pr3 + Pr5
  (16 launches per evaluation) against stand-in data (random numbers of the
  data's lengths: the work does not depend on the data): seconds per
  generation on the host clock, the mean of ``--gens`` generations after
  two warm-up ones (each generation a new candidate set from a fixed seed;
  each call ends in the host copy of the SSE), and the device's busy time
  in a profiler trace of one more generation, so its idle share.

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


def main(root: str, reps: int, gens: int) -> dict:
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

    rs = np.random.RandomState(0)
    d3, d5 = rs.randn(57806), rs.randn(92902)
    pop = 8
    objective = T.make_objective_fused(d3, d5, pop, trips=C.HH_TRIPS,
                                       device=dev)
    cands = [T.P0[None] * np.exp(0.1 * rs.randn(pop, 4))
             for _ in range(gens + 3)]
    for xs in cands[:2]:
        objective(xs)
    t = time.perf_counter()
    for xs in cands[2:2 + gens]:
        objective(xs)
    secs = (time.perf_counter() - t) / gens
    launches = H.fused_hh_pop_solve_ft.launches
    busy = _busy_ms(lambda: objective(cands[-1]))
    fit = {"s_per_generation": secs, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (secs * 1e3) if busy > 0 else None,
           "launches_per_generation":
               H.fused_hh_pop_solve_ft.launches - launches}
    out = {"root": root, "card": C.device_line(), "kernels": kernels,
           "d0_generation": fit}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose ionflux_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--gens", type=int, default=20)
    args = ap.parse_args()
    main(args.root, args.reps, args.gens)
