#!/usr/bin/env python
"""Figure 3 on the ionflux_torch port (``scripts/figure_3.py``): the
d-study predictions, Pr4's sweeps on top, the sinewave and the APs as
full-width rows with zoom panels, on the recorded cell-5 protocols.
``--s`` draws the s-study supplement (HH ground truth, out/s1, out/s2).

    python3 scripts/figure_3_torch.py [--s] [--cached]

writes fig3.png (fig3-s.png) to <outdir> (default out/figure-3-torch,
figure-3-s-torch; matplotlib), every trace cached there as npz; returns
{protocol: {model: MAE}}.  The data are the ground truth plus noise drawn
with seeds 10-12, or the reference's stored ``table-1/yc-*.pt`` traces
where ``IONFLUX_REFERENCE`` holds them (d-study only)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import outdir, parse, traced  # noqa: E402
from figure_2_torch import long_sim, models_for, parser  # noqa: E402
from table_1_torch import noisy  # noqa: E402


def cases():
    """(protocol, stored noisy trace, zooms (t0, t1, y0, y1, color));
    figure-3.py:560-578."""
    from ionflux_torch.figures import SET2

    return [
        ("pr4-cell5", None, []),
        ("sinewave-cell5", "yc-sinewave.pt",
         [(3700, 4500, -1, 14, SET2[0]), (5500, 6250, -7, 18, SET2[1]),
          (6400, 7000, -20, 2, SET2[2])]),
        ("aps-cell5", "yc-aps.pt",
         [(2400, 2800, -2, 33, SET2[0]), (4300, 4900, -1, 19, SET2[1]),
          (6100, 6500, -1, 19, SET2[2])]),
    ]


def main(argv=None) -> dict:
    args = parse(parser("Figure 3: d-study predictions, on the "
                        "ionflux_torch port."), argv)
    out = outdir(args, "figure-3-s-torch" if args.s else "figure-3-torch")

    import numpy as np
    import torch

    from ionflux_torch import protorec, studies
    from ionflux_torch._device import resolve_device
    from ionflux_torch.figures import fit_composition_rows, mae_row

    device = resolve_device(args.device)
    result, panels = {}, []
    with traced(args, out):
        models, gt_kind, gt_params = models_for(args, device)
        sim = long_sim(out, args.cached, device)
        for seed, (name, yc, zs) in enumerate(cases()):
            v, dt = protorec.load_voltage(name)
            path = os.path.join(studies.REFDIR or "", "table-1", yc or "")
            if yc and not args.s and studies.REFDIR and os.path.exists(path):
                data = np.asarray(torch.load(path, map_location="cpu",
                                             weights_only=False),
                                  np.float64).reshape(-1)
            else:
                truth = sim(f"{name}-gt{'-s' if args.s else ''}", gt_kind,
                            gt_params, name)
                data = noisy(truth, 10 + seed, device)
            preds = {label: sim(f"{name}-{label}"
                                f"{'-oracle' if args.oracle else ''}",
                                kind, params, name)
                     for label, (kind, params, _s) in models.items()}
            result[name] = mae_row(data, preds)
            for label, val in result[name].items():
                print(f"{name} ({label}) | Total Loss {val:.6f}")
            shape = (protorec.SWEEPS[name] if name in protorec.SWEEPS
                     else (1, len(v)))
            panels.append({
                "t": np.arange(shape[1]) * dt,
                "v": v.reshape(shape),
                "data": data.reshape(shape),
                "preds": {k: y.reshape(shape) for k, y in preds.items()},
                "zooms": zs,
            })
        suffix = ("-s" if args.s else "") + ("-oracle" if args.oracle
                                             else "")
        fit_composition_rows(os.path.join(out, f"fig3{suffix}.png"),
                             [panels[0]], panels[1:])
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
