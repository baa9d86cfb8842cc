#!/usr/bin/env python
"""Figure 5 on the ionflux_torch port (``scripts/figure_5.py``): the
r-study predictions, Pr4's sweeps on top and the sinewave and APs as
full-width rows with zooms, on the recorded cell-5 protocols, for the
cell-5 HH fit, r1's NN-f and r2's NN-d.  Grey traces: the Pr4 measurement
recovered from the reference's ``r1-bad/`` cache; for the sinewave and
APs, whose measurements are not recoverable, the reference's stored model
traces (``figure-5/y1-*.pt``), all under ``IONFLUX_REFERENCE``.

    python3 scripts/figure_5_torch.py [--oracle] [--cached] [--device cpu]

writes <outdir>/fig5[-oracle].png (default out/figure-5-torch;
matplotlib), every trace cached there as npz; returns {protocol: {model:
MAE against the grey trace}} (Pr4: at the measurement's samples)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, drawing, lattice, outdir,  # noqa: E402
                          parse, r_measurements, real_sim, traced)
from figure_4_torch import parser  # noqa: E402


def zooms():
    """Zoom windows, limits and facecolors (figure-5.py:476-485)."""
    from ionflux_torch.figures import SET2

    return {
        "sinewave": [(3700, 4500, 0.0, 1.0, SET2[0]),
                     (5500, 6250, -0.6, 1.4, SET2[1]),
                     (6400, 7000, -1.8, 0.2, SET2[2])],
        "aps": [(2400, 2800, -0.2, 3.3, SET2[0]),
                (4300, 4900, 0.0, 2.0, SET2[1]),
                (6100, 6500, -0.1, 2.4, SET2[2])],
    }


def main(argv=None) -> dict:
    args = parse(parser("Figure 5: r-study predictions, on the "
                        "ionflux_torch port."), argv)
    out = outdir(args, "figure-5-torch")

    import numpy as np
    import torch

    from ionflux_torch import protorec
    from ionflux_torch import rstudies as R
    from ionflux_torch._device import resolve_device
    from ionflux_torch.figures import dense_measurement, load_r_models

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    suffix = "-oracle" if args.oracle else ""
    maes, panels = {}, []
    with traced(args, out):
        rows = load_r_models(os.path.join(ROOT, "out"), oracle=args.oracle,
                             device=device)
        tl, i_meas = r_measurements(("pr4",), device)["pr4"]
        sim = real_sim(out, args.cached, device)
        for name in ("pr4", "sinewave", "aps"):
            v, dt = protorec.load_voltage(f"{name}-cell5")
            if name == "pr4":
                shape = protorec.SWEEPS["pr4-cell5"]
                idx = lattice(tl)
                data = dense_measurement(idx, i_meas, shape[0] * shape[1])
            else:
                shape = (1, len(v))
                data = np.asarray(torch.load(
                    f"{R.refdir()}/figure-5/y1-{name}.pt",
                    weights_only=False), np.float64).reshape(-1)
            preds, maes[name] = {}, {}
            for label, kind, params, c in rows:
                y = sim(f"{name}-{label}{suffix}", kind, params, name, c)
                maes[name][label] = float(np.mean(np.abs(
                    y[idx] - np.asarray(i_meas)) if name == "pr4"
                    else np.abs(y - data)))
                print(f"{name} ({label}) | Total Loss "
                      f"{maes[name][label]:.6f}")
                preds[label] = y.reshape(shape)
            panels.append({"t": np.arange(shape[1]) * dt,
                           "v": v.reshape(shape),
                           "data": data.reshape(shape), "preds": preds,
                           "zooms": zooms().get(name, [])})
        path = os.path.join(out, f"fig5{suffix}.png")
        if drawing(path):
            from ionflux_torch.figures import fit_composition_rows

            fit_composition_rows(path, [panels[0]], panels[1:])
    return maes


if __name__ == "__main__":
    main()
    sys.exit(0)
