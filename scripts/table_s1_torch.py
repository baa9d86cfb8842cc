#!/usr/bin/env python
"""Table S1 on the ionflux_torch port (``scripts/table_s1.py``): the
r1-tune architecture sweep on the recorded cell-5 protocols.

- Pr3, Pr5, Pr4: MAE against the smoothed measurements recovered from the
  reference's caches (``r1/``, ``r1-bad/`` under ``IONFLUX_REFERENCE``),
  at the capacitance-masked samples; Pr4 on sweeps 1-3.
- Sinusoidal, APs (+): MAE against the reference's stored prediction
  trace of the same architecture (``table-s1/sNN-y1-*.pt``): agreement
  with the archived run, not data MAE.

Rows are the checkpoints under out/r1-tune/<id>/best-model.npz
(``rstudies.tune_study``); an architecture without one is skipped.
``--stored-pr4`` also scores the reference's stored Pr4 traces
(``table-s1/sNN-y1-pr4.pt``) against the recovered Pr4 measurement.

    python3 scripts/table_s1_torch.py [--stored-pr4] [--device cpu]

writes <outdir>/table-s1.txt (and table-s1-stored-pr4.txt; default
out/table-s1-torch) and returns {"rows": {id: ["LxN", 5 MAEs]},
"stored_pr4": {id: [MAE]} or None}."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, lattice, outdir, parse,  # noqa: E402
                          r_measurements, real_sim, study_parser, traced)
from table_2_torch import pr4_sweeps_1_3  # noqa: E402


def _stored(arch_id: str, name: str):
    import numpy as np
    import torch

    from ionflux_torch import rstudies as R

    return np.asarray(torch.load(
        f"{R.refdir()}/table-s1/{arch_id}-y1-{name}.pt", weights_only=False),
        np.float64).reshape(-1)


def main(argv=None) -> dict:
    parser = study_parser("Table S1: architecture sweep, on the "
                          "ionflux_torch port.")
    parser.add_argument("--stored-pr4", action="store_true",
                        help="score the reference's stored traces vs the "
                             "recovered Pr4 measurement")
    args = parse(parser, argv)
    out = outdir(args, "table-s1-torch")

    import numpy as np
    import torch

    from ionflux_torch._device import resolve_device
    from ionflux_torch.figures import latex_table
    from ionflux_torch.models.registry import ARCHITECTURES
    from ionflux_torch.rstudies import tune_study
    from ionflux_torch.utils.ckpt import load_pytree

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    sim = real_sim(None, False, device)
    stored, rows = None, {}
    with traced(args, out):
        meas = r_measurements(("pr3", "pr5", "pr4"), device)
        if args.stored_pr4:
            stored = {}
            tl, i_meas = meas["pr4"]
            idx = lattice(tl)
            keep = pr4_sweeps_1_3(idx)
            for arch_id in ARCHITECTURES:
                y = _stored(arch_id, "pr4")
                stored[arch_id] = [float(np.mean(np.abs(
                    y[idx[keep]] - np.asarray(i_meas)[keep])))]
                print(f"{arch_id} stored-trace Pr4 vs recovered measurement:"
                      f" {stored[arch_id][0]:.4f}")
            latex_table(os.path.join(out, "table-s1-stored-pr4.txt"),
                        ["Pr4"], stored,
                        caption="reference stored r1-tune traces vs the "
                                "recovered Pr4 measurement (table-s1.txt "
                                "Pr4 column check)")
        for arch_id, (n_layers, n_nodes) in ARCHITECTURES.items():
            path = os.path.join(ROOT, "out", "r1-tune", arch_id,
                                "best-model.npz")
            if not os.path.exists(path):
                print(f"{arch_id}: no trained checkpoint (run scripts/"
                      f"train_r1_tune_torch.py --info {arch_id}); skipped")
                continue
            spec = tune_study(arch_id)
            params = load_pytree(path, spec.model_kind, device)
            vals = []
            for name in ("pr3", "pr5", "pr4"):
                tl, i_meas = meas[name]
                idx, i_meas = lattice(tl), np.asarray(i_meas)
                i = sim(None, spec.model_kind, params, name, spec.constants)
                if name == "pr4":
                    keep = pr4_sweeps_1_3(idx)
                    idx, i_meas = idx[keep], i_meas[keep]
                vals.append(float(np.mean(np.abs(i[idx] - i_meas))))
            for name in ("sinewave", "aps"):
                i = sim(None, spec.model_kind, params, name, spec.constants)
                vals.append(float(np.mean(np.abs(i - _stored(arch_id,
                                                             name)))))
            rows[arch_id] = [f"{n_layers}x{n_nodes}"] + vals
            print(arch_id, rows[arch_id])
        if rows:
            latex_table(
                os.path.join(out, "table-s1.txt"),
                ["arch", "Pr3", "Pr5", "Pr4", "Sinusoidal (+)", "APs (+)"],
                rows, caption="r1-tune sweep on the recorded protocols: "
                              "Pr3/Pr5/Pr4 vs recovered measurements (masked"
                              " samples); (+) columns: agreement with the "
                              "reference's stored per-arch traces")
    return {"rows": rows, "stored_pr4": stored}


if __name__ == "__main__":
    main()
    sys.exit(0)
