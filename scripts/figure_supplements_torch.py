#!/usr/bin/env python
"""The supplementary figures on the ionflux_torch port
(``scripts/figure_supplements.py``): the s-study (no-discrepancy) fits and
predictions of the true HH model, s1's NN-f and s2's NN-d on a +20 mV
activation step, a -100 mV deactivation step, the AP2Hz protocol and a
300 ms activation-time-constant step (fig-s23.png), and a phase portrait
of the Markov model's a-gate on the activation-time-constant family over
the HH a-gate's rate surface (fig-s1.png).

The data drawn are the truth plus 0.1 N(0, 1) noise from a
``torch.Generator`` seeded with the case's index (JAX's noise stream
differs); the MAEs are each model's against the noiseless truth.  AP2Hz
is read from ``IONFLUX_REFERENCE``'s ``test-protocols/ap2hz.csv``.

    python3 scripts/figure_supplements_torch.py [--cached] [--device cpu]

writes those to <outdir> (default out/figure-s-torch; matplotlib), every
trace cached there as npz; returns {case: {model: MAE}}."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, drawing, outdir, parse,  # noqa: E402
                          study_parser, traced)
from table_1_torch import noisy  # noqa: E402


def cases(device):
    """(name, protocol, output times) of fig-s23's four panels."""
    import numpy as np

    from ionflux_torch import protocols as P
    from ionflux_torch.studies import _ap2hz

    return [
        ("pr3-20mV", P.activation_protocol(20.0, dt_ms=1.0, device=device),
         np.linspace(0.0, 8000.0, 8001)),
        ("pr5--100mV", P.deactivation_protocol(-100.0, dt_ms=1.0,
                                                device=device),
         np.linspace(0.0, 10000.0, 10001)),
        ("ap2hz", _ap2hz(device), np.linspace(0.0, 3000.0, 1501)),
        ("atau-300ms", P.atau_protocol(300.0, dt_ms=1.0, device=device),
         np.linspace(0.0, 5000.0, 5001)),
    ]


def main(argv=None) -> dict:
    args = parse(study_parser("Supplementary figures (s-study), on the "
                              "ionflux_torch port."), argv)
    out = outdir(args, "figure-s-torch")

    import numpy as np
    import torch

    from ionflux_torch import protocols as P
    from ionflux_torch._device import resolve_device
    from ionflux_torch.eval import solve_states
    from ionflux_torch.figures import cached_sim, mae_row
    from ionflux_torch.models.hh import a_gate_rhs
    from ionflux_torch.models.registry import HH_B06, MARKOV_B06, SYNTHETIC
    from ionflux_torch.studies import S1, S2, load_study_params

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    result, panels = {}, []
    with traced(args, out):
        models = {"True model": ("hh", HH_B06, "C2-")}
        for spec, label, style in [(S1, "NN-f (s1)", "C0--"),
                                   (S2, "NN-d (s2)", "C1--")]:
            d = os.path.join(ROOT, "out", spec.name)
            if os.path.exists(os.path.join(d, "model.npz")):
                models[label] = (spec.model_kind,
                                 load_study_params(spec, d, device), style)
            else:
                print(f"{label}: run scripts/train_{spec.name}_torch.py "
                      "first")
        for idx, (name, proto, ts) in enumerate(cases(device)):
            truth = cached_sim(out, f"{name}-gt", args.cached, "hh", HH_B06,
                               proto, ts, SYNTHETIC)
            preds = {label: cached_sim(out, f"{name}-{label.replace(' ', '_')}",
                                       args.cached, kind, params, proto, ts,
                                       SYNTHETIC)
                     for label, (kind, params, _s) in models.items()}
            result[name] = mae_row(truth, preds)
            print(name, {k: round(v, 4) for k, v in result[name].items()})
            panels.append((name, ts, noisy(truth, idx, device), preds))

        # the phase portrait: the Markov a-gate on the atau family
        ts = torch.linspace(0.0, 5000.0, 1001, dtype=torch.float32,
                            device=device)
        y0 = torch.zeros(2, dtype=torch.float32, device=device)
        portraits = [(P.voltage(pr, ts).cpu().numpy(),
                      solve_states("gta", MARKOV_B06, pr, ts, y0=y0).cpu(
                      ).numpy()) for pr in P.atau_family(dt_ms=1.0,
                                                         device=device)]
        vv, aa = np.meshgrid(np.linspace(-130, 70, 40), np.linspace(0, 1, 40))
        zz = a_gate_rhs(HH_B06, torch.tensor(aa, dtype=torch.float32),
                        torch.tensor(vv, dtype=torch.float32)).numpy()

        path = os.path.join(out, "fig-s23.png")
        if drawing(path):
            from ionflux_torch.figures import _pyplot

            plt = _pyplot()
            fig, axes = plt.subplots(2, 2, figsize=(11, 6))
            for k, (name, ts_k, data, preds) in enumerate(panels):
                ax = axes[k // 2][k % 2]
                ax.plot(ts_k, data, c="#bbbbbb", lw=0.4)
                for label, y in preds.items():
                    ax.plot(ts_k, y, models[label][2], lw=0.9, label=label)
                if k == 0:
                    ax.legend(fontsize=7)
                ax.set_title(name, fontsize=9)
            fig.suptitle("s-study fits & predictions (figure-2-s/3-s "
                         "analogue)", fontsize=10)
            fig.tight_layout()
            fig.savefig(path, dpi=160)
            plt.close(fig)
            print(f"wrote {path}")

            fig2 = plt.figure(figsize=(5.5, 4.5))
            ax = fig2.add_subplot(111, projection="3d")
            for v, ys in portraits:
                ax.plot(v, ys[:, 0], ys[:, 1], lw=0.8)
            ax.plot_surface(vv, aa, zz, color="C1", alpha=0.3)
            ax.set_xlabel("V (mV)")
            ax.set_ylabel("a")
            ax.set_zlabel("da/dt")
            fig2.tight_layout()
            path = os.path.join(out, "fig-s1.png")
            fig2.savefig(path, dpi=170)
            plt.close(fig2)
            print(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
