#!/usr/bin/env python
"""Table 2 on the ionflux_torch port (``scripts/table_2.py``): the real
cell-5 MAEs of the cell-5 HH fit (Original), r1's NN-f and r2's NN-d.

The measured columns (Pr3, Pr5, Pr4 on sweeps 1-3) score each model's
chained solve at the capacitance-masked samples against the smoothed
measurement recovered from the reference's surface caches (``r1/``,
``r1-bad/`` under ``IONFLUX_REFERENCE``); the sinusoidal and APs columns
(+) score the model against the reference's archived simulated trace of
the same model family (``table-2/{yo,y1,y2}-{sinewave,aps}.pt``).  The
nets are the trained best checkpoints out/r1, out/r2, or with
``--oracle`` the reference's archived ones (``r1/best-model-checkpoint-
2.pt``, ``r2/model-state-dict-2.pt``).

    python3 scripts/table_2_torch.py [--oracle] [--device cpu]

writes <outdir>/table-2[-oracle].txt (default out/table-2-torch) and
returns {label: [Pr3, Pr5, Pr4, Sinusoidal, APs MAEs]}."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, lattice, outdir, parse,  # noqa: E402
                          r_measurements, real_sim, study_parser, traced)

COLS = ["Pr3", "Pr5", "Pr4", "Sinusoidal (+)", "APs (+)"]
TAGS = {"Original": "yo", "NN-f": "y1", "NN-d": "y2"}
CAPTION = ("real cell-5 MAE (nA) at capacitance-masked samples vs the "
           "recovered smoothed measurements; (+) columns: MAE vs the "
           "reference's archived simulated trace for the same model family "
           "(table-2/y*-{sinewave,aps}.pt; measured currents not "
           "recoverable)")


def pr4_sweeps_1_3(idx):
    """The Pr4 lattice points of sweeps 1-3 (the table's Pr4 span)."""
    from ionflux_torch import protorec

    n = protorec.PR4_N // 16
    return (idx >= n) & (idx < 4 * n)


def main(argv=None) -> dict:
    parser = study_parser("Table 2: real-data MAE table, on the "
                          "ionflux_torch port.")
    parser.add_argument("--oracle", action="store_true",
                        help="the reference's archived checkpoints")
    args = parse(parser, argv)
    out = outdir(args, "table-2-torch")

    import numpy as np
    import torch

    from ionflux_torch import rstudies as R
    from ionflux_torch._device import resolve_device
    from ionflux_torch.figures import latex_table, load_r_models

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    sim = real_sim(None, False, device)
    rows_out = {}
    with traced(args, out):
        meas = r_measurements(("pr3", "pr5", "pr4"), device)
        for label, kind, params, c in load_r_models(
                os.path.join(ROOT, "out"), oracle=args.oracle,
                device=device):
            vals = []
            for name in ("pr3", "pr5", "pr4"):
                tl, i_meas = meas[name]
                idx, i_meas = lattice(tl), np.asarray(i_meas)
                i = sim(None, kind, params, name, c)
                if name == "pr4":
                    keep = pr4_sweeps_1_3(idx)
                    idx, i_meas = idx[keep], i_meas[keep]
                vals.append(float(np.mean(np.abs(i[idx] - i_meas))))
                print(f"{name} ({label}) | Total Loss {vals[-1]:.6f}")
            for name in ("sinewave", "aps"):
                stored = f"{R.refdir()}/table-2/{TAGS[label]}-{name}.pt"
                ref_i = np.asarray(torch.load(stored, weights_only=False),
                                   np.float64).reshape(-1)
                i = sim(None, kind, params, name, c)
                vals.append(float(np.mean(np.abs(i - ref_i))))
                print(f"{name} ({label}) vs stored {TAGS[label]}-{name}.pt "
                      f"| {vals[-1]:.6f}")
            rows_out[label] = vals
        suffix = "-oracle" if args.oracle else ""
        latex_table(os.path.join(out, f"table-2{suffix}.txt"), COLS,
                    rows_out, caption=CAPTION)
    return rows_out


if __name__ == "__main__":
    main()
    sys.exit(0)
