#!/usr/bin/env python
"""Supplementary figure 0-s on the ionflux_torch port
(``scripts/figure_0_s.py``): the spline-smoothing demonstration, a noisy
simulated current -> Hanning smooth -> cubic spline -> analytic dI/dt, with
zoom panels around the 1,000 ms step.

    python3 scripts/figure_0_s_torch.py [--device cpu]

writes <outdir>/fig0s.png (default out/figure-0-s-torch; matplotlib) and
returns (t, noisy, i_smooth, didt)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import outdir, parse, study_parser, traced  # noqa: E402


def main(argv=None):
    args = parse(study_parser("Figure 0-s: spline smoothing demo, on the "
                              "ionflux_torch port."), argv)
    out = outdir(args, "figure-0-s-torch")

    import numpy as np
    import torch

    from ionflux_torch import protocols as P
    from ionflux_torch._device import resolve_device
    from ionflux_torch.data import simulate_current
    from ionflux_torch.figures import _pyplot
    from ionflux_torch.models.registry import HH_B06, SYNTHETIC
    from ionflux_torch.observe import add_noise
    from ionflux_torch.surface import SurfaceConfig, spline_didt

    device = resolve_device(args.device)
    with traced(args, out):
        proto = P.activation_protocol(20.0, device=device)
        ts = torch.linspace(0.0, 8000.0, 80001, dtype=torch.float32,
                            device=device)
        clean = simulate_current(HH_B06, proto, ts, SYNTHETIC)
        noisy = add_noise(torch.Generator(device=device).manual_seed(0),
                          clean).double().cpu().numpy()
        edges = P.segment_edges(proto.times().cpu().numpy(),
                                proto.v.cpu().numpy())
        t = ts.cpu().numpy()
        i_smooth, didt = spline_didt(t.astype(np.float64), noisy, edges,
                                     SurfaceConfig())

        plt = _pyplot()
        fig, axes = plt.subplots(2, 2, figsize=(10, 6))
        axes[0, 0].plot(t, noisy, c="#bbbbbb", lw=0.5, label="noisy I")
        axes[0, 0].plot(t, i_smooth, "C0", lw=1.0, label="smooth+spline")
        axes[0, 0].legend(fontsize=8)
        axes[0, 0].set_title("current")
        axes[1, 0].plot(t, didt, "C1", lw=0.8)
        axes[1, 0].set_title("spline dI/dt")
        m = (t > 900) & (t < 1400)
        axes[0, 1].plot(t[m], noisy[m], c="#bbbbbb", lw=0.5)
        axes[0, 1].plot(t[m], i_smooth[m], "C0", lw=1.0)
        axes[0, 1].set_title("zoom: step at 1000 ms")
        axes[1, 1].plot(t[m], didt[m], "C1", lw=0.8)
        for ax in axes.flat:
            ax.set_xlabel("t (ms)")
        fig.tight_layout()
        fig.savefig(os.path.join(out, "fig0s.png"), dpi=200)
        plt.close(fig)
        print(f"wrote {out}/fig0s.png")
    return t, noisy, i_smooth, didt


if __name__ == "__main__":
    main()
    sys.exit(0)
