#!/usr/bin/env python
"""``realdata.recover_measurements`` on the card, in float32 and float64, on
the full-length stand-in caches of ``_r_study_standins``, against the
one-clock r-gate solve that the JAX package's ``recover_measurements`` makes.

    python3 tests/_r_recovery_probe.py [--device cuda]

The port solves the r-gate per sweep on local clocks, chained; one clock
over each 46-93 s recording is JAX's way.  For each cache (r1/, r1-bad/),
solve and dtype it prints the seconds of the recovery (the card
synchronised) and, per protocol, the largest error of the recovered current
against a g r (V - E) with r by the exact propagator (a fraction of the
current's range), where it falls, and the share of points within 1e-4;
then one JSON line of the same numbers."""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import _r_study_standins as RS  # noqa: E402

from ionflux_torch import protorec  # noqa: E402
from ionflux_torch import realdata  # noqa: E402
from ionflux_torch.models import registry as REG  # noqa: E402
from ionflux_torch.surface import solve_r_gate  # noqa: E402

CACHES = (("r1", REG.CELL5_R1, REG.HH_CELL5_INIT, {}),
          ("r1-bad", REG.CELL5_R1BAD, REG.HH_R1BAD_INIT,
           dict(protocols=("pr3", "pr4"), n_points=30)))


def one_clock(surface_dir, c, rgate, protocols=("pr3", "pr5"), n_points=70,
              dtype=None, *, device=None):
    """``recover_measurements`` as the JAX package computes it: each
    recording's r-gate by one adaptive solve on one clock."""
    v = realdata._pt_load(f"{surface_dir}/v.pt")
    a = realdata._pt_load(f"{surface_dir}/a.pt")
    sel_t, sel_m = realdata._cache_lattice(surface_dir, protocols, v,
                                           n_points)
    out = {}
    for name in protocols:
        tl, sel = sel_t[name], sel_m[name]
        proto = protorec.protocol(f"{name}-cell5", dtype=dtype,
                                  device=device)
        ts = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                        torch.as_tensor(tl, device=device).to(dtype)])
        r = solve_r_gate(proto, ts, rgate, max_steps=1_000_000,
                         buffer_size=65536).cpu().numpy()[1:]
        out[name] = (tl, a[sel] * float(c.g) * r * (v[sel] - float(c.e)))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    solves = (("chained", realdata.recover_measurements),
              ("one clock", one_clock))
    out = {}
    with tempfile.TemporaryDirectory() as ref:
        RS.write_r_caches(ref)
        for sub, c, rg, kw in CACHES:
            d = f"{ref}/{sub}"
            for label, recover in solves:
                for dtype in (torch.float32, torch.float64):
                    sync()
                    t = time.perf_counter()
                    got = recover(d, c, rg, dtype=dtype, device=dev, **kw)
                    sync()
                    row = {"seconds": time.perf_counter() - t}
                    for name, (tl, err) in RS.recovery_errors(
                            d, got, c, rg).items():
                        k = int(np.argmax(err))
                        row[name] = {"max_err": float(err[k]),
                                     "at_ms": float(tl[k]),
                                     "within_1e-4": float(np.mean(
                                         err <= 1e-4))}
                    key = f"{sub} {label} {str(dtype)[6:]}"
                    out[key] = row
                    print(key, row, flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
