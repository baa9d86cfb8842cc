#!/usr/bin/env python3
"""Where the batched checkpoint scoring and the plain chained solve part:
one D2 checkpoint's currents on the five table-1 recordings through B1's
chained launches (``eval.simulate_population_real``, 64 copies, the
study's 8,192 trips, rtol 1e-6 / atol 1e-8) against the plain chained
solve (``studies._sim_real_table``), for the untrained init and after
``--iters`` Adam updates on D2's full surface (seed 0, the recipe's rate).

    python3 scripts/probe_chain_vs_plain_torch.py [--iters 400]

Prints one JSON line per (net, recording): max and mean |dI| (nA), the max
as a share of the plain current's range, where it falls (sweep, local ms),
and both MAEs against the study's noisy targets over the whole
recording.  Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ionflux_torch import eval as E  # noqa: E402
from ionflux_torch import protorec  # noqa: E402
from ionflux_torch import studies as S  # noqa: E402
from ionflux_torch.fit import train as FT  # noqa: E402
from ionflux_torch.models import nn as N  # noqa: E402
from ionflux_torch.models.registry import TABLE1  # noqa: E402
from ionflux_torch.ops import _build  # noqa: E402


def _population(params, members: int = 64):
    return N.NNdParams(N.MLP([(w[None].repeat(members, 1, 1),
                               b[None].repeat(members, 1))
                              for w, b in params.net.layers]), params.hh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--trips", type=int, default=8192)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for name in _build.build():
        _build.load_library(name)
    with tempfile.TemporaryDirectory() as tmp:
        v, a, dadt = S.study_surface(S.D2, tmp, device=dev)
    keep = (a > 0) & (a < 1)
    x = torch.as_tensor(np.stack([v[keep] / 100.0, a[keep]], -1),
                        dtype=torch.float32, device=dev)
    y = torch.as_tensor(dadt[keep], dtype=torch.float32, device=dev)
    res = S.a_gate_rhs(S.D2.base_hh, x[:, 1], x[:, 0] * 100.0)
    init = S.init_params(S.D2, device=dev)
    net, _, _ = FT.fit_chunk(init.net, FT.init_opt_state(init.net), x, y,
                             res, iters=args.iters, lr=1e-3,
                             step_size=S.D2.step_size, gamma=0.9)
    S._table_targets(S.D2, True, dev)
    names = [n for _, n, _ in S._TABLE_COLS]
    for label, params in (("init", init), (f"{args.iters} updates",
                                            S.wrap_net(S.D2, net))):
        cur = E.simulate_population_real("nnd", _population(params), names,
                                         TABLE1, trips=args.trips,
                                         rtol=1e-6, atol=1e-8)
        for n in names:
            plain = S._sim_real_table("nnd", params, n)
            chain = cur[n][0].astype(np.float64)
            truth = S._GT_ROLLOUTS[S._gt_key(S.D2, n, True)]
            d = np.abs(chain - plain)
            i = int(np.argmax(d))
            period = protorec.SWEEPS.get(n, (1, len(plain)))[1]
            print(json.dumps({
                "net": label, "recording": n, "max_abs_di": float(d.max()),
                "max_of_range": float(d.max() / np.ptp(plain)),
                "mean_abs_di": float(d.mean()), "at_sweep": i // period,
                "at_local_ms": round((i % period) * 0.1, 1),
                "mae_chain": float(np.mean(np.abs(chain - truth))),
                "mae_plain": float(np.mean(np.abs(plain - truth)))}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
