#!/usr/bin/env python
"""Figure 4 on the ionflux_torch port (``scripts/figure_4.py``): the
r-study training fits, the measured cell-5 data against the cell-5 HH fit
(Original), r1's NN-f and r2's NN-d on the recorded Pr3 and Pr5 protocols,
the sweeps overlaid, with shaded zoom panels.  The grey data trace is the
smoothed measurement recovered from the reference's surface caches
(``r1/`` under ``IONFLUX_REFERENCE``; its gaps at the step edges are the
mask's).  ``--oracle`` draws the reference's archived checkpoints.

    python3 scripts/figure_4_torch.py [--oracle] [--cached] [--device cpu]

writes <outdir>/fig4[-oracle].png (default out/figure-4-torch;
matplotlib), every trace cached there as npz; returns {protocol: {model:
MAE at the measurement's samples}}."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, drawing, lattice, outdir,  # noqa: E402
                          parse, r_measurements, real_sim, study_parser,
                          traced)


def parser(description: str):
    p = study_parser(description)
    p.add_argument("--oracle", action="store_true",
                   help="the reference's archived checkpoints")
    return p


def fit_columns(args, out, device):
    """Pr3 and Pr5 as figure columns {name: (t, v, data, preds,
    n_sweeps)} (each [n_sweeps, period]), and {name: {label: MAE}}; each
    MAE printed as the reference's loss line."""
    import numpy as np

    from ionflux_torch import protorec
    from ionflux_torch.figures import dense_measurement, load_r_models

    rows = load_r_models(os.path.join(ROOT, "out"), oracle=args.oracle,
                         device=device)
    meas = r_measurements(("pr3", "pr5"), device)
    sim = real_sim(out, args.cached, device)
    suffix = "-oracle" if args.oracle else ""
    cols, maes = {}, {}
    for name in ("pr3", "pr5"):
        n_sweeps, period = protorec.SWEEPS[f"{name}-cell5"]
        v, dt = protorec.load_voltage(f"{name}-cell5")
        tl, i_meas = meas[name]
        idx = lattice(tl)
        data = dense_measurement(idx, i_meas, n_sweeps * period)
        preds, maes[name] = {}, {}
        for label, kind, params, c in rows:
            y = sim(f"{name}-{label}{suffix}", kind, params, name, c)
            maes[name][label] = float(np.mean(np.abs(
                y[idx] - np.asarray(i_meas))))
            print(f"{name} ({label}) | Total Loss {maes[name][label]:.6f}")
            preds[label] = y.reshape(n_sweeps, period)
        cols[name] = (np.arange(period) * dt, v.reshape(n_sweeps, period),
                      data.reshape(n_sweeps, period), preds, n_sweeps)
    return cols, maes


def zooms():
    """Zoom windows, limits and facecolors (figure-4.py:455-462)."""
    from ionflux_torch.figures import SET2

    return {
        "pr3": [(1000, 5000, -0.1, 0.7, SET2[0]),
                (6600, 7100, -4.0, 0.5, SET2[1])],
        "pr5": [(2600, 3000, -4.0, 2.0, SET2[2]),
                (8650, 9100, -3.0, 0.5, SET2[3])],
    }


def main(argv=None) -> dict:
    args = parse(parser("Figure 4: r-study fits, on the ionflux_torch "
                        "port."), argv)
    out = outdir(args, "figure-4-torch")

    import torch

    from ionflux_torch._device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    with traced(args, out):
        cols, maes = fit_columns(args, out, device)
        path = os.path.join(out, f"fig4{'-oracle' if args.oracle else ''}"
                                 ".png")
        if drawing(path):
            from ionflux_torch.figures import fit_composition_cols

            fit_composition_cols(path, [
                {"t": t, "v": v, "data": data, "preds": preds,
                 "zooms": zooms()[name]}
                for name, (t, v, data, preds, _) in cols.items()])
    return maes


if __name__ == "__main__":
    main()
    sys.exit(0)
