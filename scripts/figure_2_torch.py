#!/usr/bin/env python
"""Figure 2 on the ionflux_torch port (``scripts/figure_2.py``): the
d-study training fits, Markov ground-truth data against the fitted
candidate (Original), NN-f and NN-d on the recorded Pr3 / Pr5 protocols,
the sweeps overlaid, with shaded zoom panels.  ``--s`` draws the s-study
supplement (HH ground truth, the s1 / s2 models from out/s1, out/s2).

    python3 scripts/figure_2_torch.py [--s] [--cached]

writes fig2.png (fig2-s.png) to <outdir> (default out/figure-2-torch,
figure-2-s-torch; matplotlib), every trace cached there as npz; returns
{protocol: {model: MAE}}.  ``--oracle`` draws the reference's archived
checkpoints (``d1/``, ``d2/`` or ``s1/``, ``s2/model-state-dict.pt`` under
``IONFLUX_REFERENCE``; FileNotFoundError naming the file where absent)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, outdir, parse, study_parser,  # noqa: E402
                          traced)
from table_1_torch import noisy  # noqa: E402


def models_for(args, device):
    """The trio to draw and the ground truth (kind, params)."""
    from ionflux_torch.figures import (load_d_models,
                                       load_d_models_reference,
                                       load_s_models)
    from ionflux_torch.models.registry import HH_B06, MARKOV_B06

    if args.s:
        return (load_s_models(None if args.oracle
                              else os.path.join(ROOT, "out"), device=device),
                "hh", HH_B06)
    if args.oracle:
        return load_d_models_reference(device=device), "markov", MARKOV_B06
    return load_d_models(os.path.join(ROOT, "out"), device), "markov", \
        MARKOV_B06


def parser(description: str):
    p = study_parser(description)
    p.add_argument("--oracle", action="store_true",
                   help="use the reference's archived checkpoints")
    p.add_argument("--s", action="store_true",
                   help="the s-study supplement (HH ground truth, s1/s2)")
    return p


def long_sim(out, cached, device):
    """Simulate a recording with an npz cache in out (the multi-sweep ones
    by the segment-chained solve)."""
    import numpy as np

    from ionflux_torch import protorec
    from ionflux_torch.eval import simulate, simulate_long
    from ionflux_torch.models.registry import TABLE1

    def sim(cache_name, kind, params, proto_name):
        path = os.path.join(out, f"{cache_name}.npz")
        if cached and os.path.exists(path):
            with np.load(path) as z:
                return z["y"]
        if proto_name in protorec.SWEEPS:
            y = simulate_long(kind, params, proto_name, TABLE1,
                              device=device)
        else:
            import torch

            proto = protorec.protocol(proto_name, device=device)
            v, dt = protorec.load_voltage(proto_name)
            ts = torch.as_tensor(np.arange(len(v)) * dt, device=device).to(
                torch.float32)
            y = simulate(kind, params, proto, ts, TABLE1,
                         max_steps=1_000_000, buffer_size=65536)
        y = y.double().cpu().numpy()
        np.savez(path, y=y)
        return y

    return sim


# zoom windows, limits and facecolors (figure-2.py:538-549)
def zooms():
    from ionflux_torch.figures import SET2

    return {
        "pr3-cell5": [(1000, 5000, -1, 4, SET2[0]),
                      (6600, 7100, -19, 1, SET2[1])],
        "pr5-cell5": [(2600, 3000, -24, 18, SET2[2]),
                      (8650, 9100, -6, 1, SET2[3])],
    }


def main(argv=None) -> dict:
    args = parse(parser("Figure 2: d-study fits, on the ionflux_torch "
                        "port."), argv)
    out = outdir(args, "figure-2-s-torch" if args.s else "figure-2-torch")

    import numpy as np

    from ionflux_torch import protorec
    from ionflux_torch._device import resolve_device
    from ionflux_torch.figures import fit_composition_cols, mae_row

    device = resolve_device(args.device)
    result, columns = {}, []
    with traced(args, out):
        models, gt_kind, gt_params = models_for(args, device)
        sim = long_sim(out, args.cached, device)
        for seed, name in enumerate(["pr3-cell5", "pr5-cell5"]):
            n_sweeps, period = protorec.SWEEPS[name]
            v, dt = protorec.load_voltage(name)
            t = np.arange(period) * dt
            truth = sim(f"{name}-gt{'-s' if args.s else ''}", gt_kind,
                        gt_params, name)
            data = noisy(truth, seed, device)
            preds = {label: sim(f"{name}-{label}"
                                f"{'-oracle' if args.oracle else ''}",
                                kind, params, name)
                     for label, (kind, params, _s) in models.items()}
            result[name] = mae_row(data, preds)
            for label, val in result[name].items():
                print(f"{name} ({label}) | Total Loss {val:.6f}")
            columns.append({
                "t": t,
                "v": v.reshape(n_sweeps, period),
                "data": data.reshape(n_sweeps, period),
                "preds": {k: y.reshape(n_sweeps, period)
                          for k, y in preds.items()},
                "zooms": zooms()[name],
            })
        suffix = ("-s" if args.s else "") + ("-oracle" if args.oracle
                                             else "")
        fit_composition_cols(os.path.join(out, f"fig2{suffix}.png"),
                             columns)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
