#!/usr/bin/env python
"""Time the forward path of one checkout of ``ionflux_torch`` on the card,
to compare two commits inside one run.

    python3 scripts/time_forward_torch.py [--root DIR] [--reps 3]

``--root`` names the checkout whose ``ionflux_torch`` is timed (default:
this one); its kernels are built there at first use.  The weights, the
protocols and chip_smoke.py's helpers come from this checkout.  The shapes
are chip_smoke.py's phases (b), (b'), (c), (k), (l) and (m), 4096 trips
each unless named:

- B2: the trained d1 sweep over the activation family (B = 7, 80,001
  knots, rtol 1e-6), and at (b')'s B = 40 (1 s of activation steps at 0.1
  ms knots, 512 trips);
- B6: the while-loop sweep of d1 at (l) (B2's shape, max_rec 16384;
  executed steps in place of trips);
- B1: 64 perturbed d1 members over the deactivation family (9 rows padded
  to 16, 100,001 knots), and the first 32 of them (the same work per block
  on half the grid, with half the weights in the L2);
- B1 bf16: (m)'s 64 members of the 5 x 200 ``nnf_init`` net in
  ``mxu_bf16`` over the deactivation family;
- B4: the 64 d1 members on the +20 mV activation protocol.

Prints one JSON line: the checkout, the card's name and power limit, the
host seconds per call of ``simulate_family`` and ``simulate_population``
(mean of ``--reps`` calls after a warm-up, each ending in a synchronise)
and for each trip kernel its milliseconds (CUDA events, mean of ``--reps``
launches after a warm-up), its executed trips (``n_valid``), the
milliseconds per executed trip, and a SHA-256 of its executed records (equal
hashes: identical records).  To compare a parent with a change, run parent,
change, change, parent in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(root: str, reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("time_forward_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(root))
    C = _chip_smoke()
    from ionflux_torch import eval as E
    from ionflux_torch import protocols as P
    from ionflux_torch.models import nn as N
    from ionflux_torch.models.registry import HH_B06, SYNTHETIC
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.utils.ckpt import (load_pytree, params_from_leaves,
                                         params_to_leaves)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    d1_path = os.path.join(HERE, "out", "d1", "model.npz")
    d1 = load_pytree(d1_path, "nnf", device=dev)
    pop = params_from_leaves(C.population(C.npz_leaves(d1_path), C.P_POP, 0),
                             "nnf", dev)
    pop32 = [(w[:32], b[:32]) for w, b in pop.net.layers]
    wide = N.nnf_init(torch.Generator().manual_seed(0), HH_B06, 5, 200,
                      device=dev)
    popw = params_from_leaves(
        C.population(params_to_leaves(wide), C.P_POP, 0), "nnf", dev)
    act = P.activation_family(0.1, device=dev)
    deact = P.deactivation_family(0.1, device=dev)
    act20 = P.activation_protocol(20.0, 0.1, device=dev)
    ts_a, ts_d, ts_20 = act[0].times(), deact[0].times(), act20.times()
    b_a, b_d = P.stack(act), P.stack(deact)

    calls = {
        "sweep": lambda: E.simulate_family("nnf", d1, act, ts_a, SYNTHETIC,
                                           backend="pallas", trips=C.TRIPS),
        "popsweep": lambda: E.simulate_population(
            "nnf", pop, deact, ts_d, SYNTHETIC, trips=C.TRIPS)}
    host = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            call()
            torch.cuda.synchronize()
        host[name] = (time.perf_counter() - t) / reps

    def popsweep(nets, rgate, bf16):
        return F._popsweep_setup(nets, rgate, b_d.v, ts_d, 0.0, 0.1,
                                 float(ts_d[-1]), 1e-5, 1e-7, C.TRIPS, None,
                                 None, True, bf16, 1)

    v40 = torch.full((C.B40, 10001), -80.0, device=dev)
    v40[:, 1000:] = torch.linspace(-60.0, 60.0, C.B40, device=dev)[:, None]
    ts40 = torch.arange(0, 10001, 10, device=dev).float() * 0.1
    setups = {
        "B2 sweep": F._sweep_setup(
            d1.net, d1.rgate, b_a.v, ts_a, 0.0, 0.1, float(ts_a[-1]), 1e-6,
            1e-8, C.TRIPS, None),
        "B2 sweep B=40": F._sweep_setup(
            d1.net, d1.rgate, v40, ts40, 0.0, 0.1, 1000.0,
            C.B40_TOL["rtol"], C.B40_TOL["atol"], C.B40_TRIPS, None),
        "B6 while sweep (l)": F._sweep_setup(
            d1.net, d1.rgate, b_a.v, ts_a, 0.0, 0.1, float(ts_a[-1]),
            C.WHILE["rtol"], C.WHILE["atol"], C.WHILE["max_rec"], None,
            block=1),
        "B1 popsweep": popsweep(pop.net, pop.rgate, False),
        "B1 popsweep P=32": popsweep(pop32, pop.rgate, False),
        "B1 popsweep bf16 (m)": popsweep(popw.net, popw.rgate, True),
        "B4 population": F._pop_setup(
            pop.net.layers, pop.rgate, act20.v, ts_20, 0.0, 0.1,
            float(ts_20[-1]), 1e-5, 1e-7, C.TRIPS)}
    kernel = {}
    for name, s in setups.items():
        if name.startswith("B6"):
            # n_out = (n_acc, steps taken); only accepted steps are recorded
            ms, out = C.cuda_ms(lambda s=s: F._while_solve_cuda(
                s, C.WHILE["max_steps"]), reps)
            n_valid, n_rec = int(out[3][1]), abs(int(out[3][0]))
        else:
            ms, out = C.cuda_ms(lambda s=s: F._trip_solve_cuda(s), reps)
            n_valid = n_rec = int(out[3][1])
        digest = hashlib.sha256()
        for rec in out[:3]:
            digest.update(rec[:n_rec].cpu().numpy().tobytes())
        kernel[name] = {"ms": ms, "n_acc": int(out[3][0]),
                        "n_valid": n_valid, "ms_per_trip": ms / n_valid,
                        "records_sha256": digest.hexdigest()[:16]}
    out = {"root": os.path.abspath(root), "card": C.device_line(),
           "host_s": host, "kernels": kernel}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose ionflux_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    main(args.root, args.reps)
