#!/usr/bin/env python
"""Figure 6 on the ionflux_torch port (``scripts/figure_6.py``): the r1-bad
negative control, a model trained on too few protocols (Pr3 + Pr4) fits
its training data and fails on the unseen deactivation steps.  A Pr4
column (r1-bad's training data) and a Pr5 column (unseen), each with the
measurement recovered from the reference's caches (``r1-bad/``, ``r1/``)
against the cell-5 HH fit, the reference's archived r1-bad net
(``r1-bad/model-state-dict.pt``) and the committed out/r1-bad (the final
model, as the reference's analysis uses), all under ``IONFLUX_REFERENCE``.

    python3 scripts/figure_6_torch.py [--cached] [--device cpu]

writes <outdir>/fig6.png (default out/figure-6-torch; matplotlib), every
trace cached there as npz; returns {protocol: {model: MAE}}."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, drawing, lattice, outdir,  # noqa: E402
                          parse, r_measurements, real_sim, study_parser,
                          traced)
from figure_7_torch import load_model  # noqa: E402


def zooms():
    from ionflux_torch.figures import SET2

    return {
        "pr4": [(850, 1100, -3.0, 8.0, SET2[0]),
                (1060, 1260, -3.0, 2.0, SET2[1])],
        "pr5": [(2600, 3000, -4.0, 2.0, SET2[2]),
                (8650, 9100, -3.0, 0.5, SET2[3])],
    }


def main(argv=None) -> dict:
    args = parse(study_parser("Figure 6: r1-bad negative control, on the "
                              "ionflux_torch port."), argv)
    out = outdir(args, "figure-6-torch")

    import numpy as np
    import torch

    from ionflux_torch import protorec
    from ionflux_torch._device import resolve_device
    from ionflux_torch.figures import dense_measurement
    from ionflux_torch.models.registry import (CELL5_R1BAD, CELL5_RAW,
                                               HH_CELL5_FIT)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    maes, columns = {}, []
    with traced(args, out):
        models = {
            "Original": ("hh", HH_CELL5_FIT, CELL5_RAW),
            "NN-f (r1-bad ref)": ("nnf", load_model(True, device),
                                  CELL5_R1BAD),
        }
        if os.path.exists(os.path.join(ROOT, "out", "r1-bad", "model.npz")):
            models["NN-f (r1-bad ours)"] = ("nnf", load_model(False, device),
                                            CELL5_R1BAD)
        meas = r_measurements(("pr5", "pr4"), device)
        sim = real_sim(out, args.cached, device)
        for name in ("pr4", "pr5"):
            n_sweeps, period = protorec.SWEEPS[f"{name}-cell5"]
            v, dt = protorec.load_voltage(f"{name}-cell5")
            tl, i_meas = meas[name]
            idx = lattice(tl)
            data = dense_measurement(idx, i_meas, n_sweeps * period)
            preds, maes[name] = {}, {}
            for label, (kind, params, c) in models.items():
                y = sim(f"{name}-{label}", kind, params, name, c)
                preds[label] = y.reshape(n_sweeps, period)
                maes[name][label] = float(np.mean(np.abs(
                    y[idx] - np.asarray(i_meas))))
                print(f"{name} ({label}) | Total Loss "
                      f"{maes[name][label]:.6f}")
            columns.append({"t": np.arange(period) * dt,
                            "v": v.reshape(n_sweeps, period),
                            "data": data.reshape(n_sweeps, period),
                            "preds": preds, "zooms": zooms()[name]})
        path = os.path.join(out, "fig6.png")
        if drawing(path):
            from ionflux_torch.figures import fit_composition_cols

            fit_composition_cols(path, columns)
    return maes


if __name__ == "__main__":
    main()
    sys.exit(0)
