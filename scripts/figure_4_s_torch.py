#!/usr/bin/env python
"""Figure 4-s on the ionflux_torch port (``scripts/figure_4_s.py``): the
r-study supplement, the cell-5 HH fit (Mo), r1's NN-f (M1) and r2's NN-d
(M2) on the recorded Pr3 and Pr5 protocols, as per-step panels
(pr3/s0..s6, pr5/s0..s8), all-steps overlays (pr3, pr3-z, pr5) and the
fig4-s composition (Pr3's voltage and current over one zoom panel a
model).  The data are figure 4's: the measurement recovered from the
reference's ``r1/`` cache under ``IONFLUX_REFERENCE``.

    python3 scripts/figure_4_s_torch.py [--oracle] [--cached] [--device cpu]

writes those under <outdir> (default out/figure-4-s-torch; matplotlib),
every trace cached there as npz; returns {protocol: {model: MAE}}."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import drawing, outdir, parse, traced  # noqa: E402
from figure_4_torch import fit_columns, parser  # noqa: E402

LEGEND = {"Original": "Original", "NN-f": "Full NN",
          "NN-d": "NN discrepancy"}
# the composition's zoom on Pr3: window (ms), current limits (nA), and the
# current panel's limits (figure-4-s.py:455-462)
ZOOM = ((1000, 5000), (-0.1, 0.7), (-0.5, 2))


def draw_steps(out: str, name: str, col) -> None:
    """The per-step panels and the all-steps overlay of one protocol
    (figure-4-s.py:361-383)."""
    from ionflux_torch.figures import MODEL_STYLES, _pyplot

    plt = _pyplot()
    t, _v, data, preds, n_sweeps = col
    os.makedirs(os.path.join(out, name), exist_ok=True)
    fig1, ax1 = plt.subplots(1, 1, figsize=(6, 4))
    ax1.set_xlabel("Time (ms)")
    ax1.set_ylabel("Current (nA)")
    for i in range(n_sweeps):
        ax1.plot(t, data[i], c="#7f7f7f",
                 label="__nolegend__" if i else "Data")
        fig2, ax2 = plt.subplots(1, 1, figsize=(6, 4))
        ax2.set_xlabel("Time (ms)")
        ax2.set_ylabel("Current (nA)")
        ax2.plot(t, data[i], c="#7f7f7f", label="Data")
        for label, y in preds.items():
            fmt, color = MODEL_STYLES[label]
            ax1.plot(t, y[i], fmt, c=color,
                     label="__nolegend__" if i else LEGEND[label])
            ax2.plot(t, y[i], fmt, c=color, label=LEGEND[label])
        ax2.set_xlim(t.min(), t.max())
        ax2.legend()
        fig2.tight_layout()
        fig2.savefig(os.path.join(out, name, f"s{i}"), dpi=200)
        plt.close(fig2)
    ax1.set_xlim(t.min(), t.max())
    ax1.legend()
    fig1.tight_layout()
    fig1.savefig(os.path.join(out, name), dpi=200 if name == "pr3" else 300)
    if name == "pr3":  # the zoomed overlay
        ax1.set_xlim(5000, 7000)
        fig1.tight_layout()
        fig1.savefig(os.path.join(out, f"{name}-z"), dpi=200)
    plt.close(fig1)


def main(argv=None) -> dict:
    args = parse(parser("Figure 4-s: r-study supplement, on the "
                        "ionflux_torch port."), argv)
    out = outdir(args, "figure-4-s-torch")

    import torch

    from ionflux_torch._device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    with traced(args, out):
        cols, maes = fit_columns(args, out, device)
        path = os.path.join(out, f"fig4-s{'-oracle' if args.oracle else ''}"
                                 ".png")
        if drawing(path):
            from ionflux_torch.figures import (SET2, _pyplot, _sns_theme,
                                               fit_composition_permodel_zoom)

            plt = _pyplot()
            _sns_theme(plt)
            plt.rcParams["axes.facecolor"] = "#E4EDE4"
            for name, col in cols.items():
                draw_steps(out, name, col)
            t, v, data, preds, _ = cols["pr3"]
            fit_composition_permodel_zoom(
                path, t, v, data, preds, zoom=ZOOM[0], zoom_ylim=ZOOM[1],
                facecolor=SET2[0], ylim=ZOOM[2])
    return maes


if __name__ == "__main__":
    main()
    sys.exit(0)
