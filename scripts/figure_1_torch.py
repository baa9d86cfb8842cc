#!/usr/bin/env python
"""Figure 1 on the ionflux_torch port (``scripts/figure_1.py``): 3-D (V, a,
da/dt) phase portraits on the recorded Pr3 / Pr5 protocols.  Panel A: the
d0-fitted candidate's trajectories lie on its own da/dt surface; panel B:
the 3-state ground truth's leave it.  ``--s1`` / ``--s2`` draw the
supplementary variants (Pr3 + Pr4; the sinewave + the APs).

    python3 scripts/figure_1_torch.py [--s1 | --s2] [--cached]

writes fig1.png (fig1-s1.png, fig1-s2.png) to <outdir> (default
out/figure-1-torch, -s1-torch, -s2-torch; matplotlib), the trajectories
cached there as <protocol>-<hh|gta>.npz; returns the figure's path."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import outdir, parse, study_parser, traced  # noqa: E402

PR3_COLOR, PR5_COLOR = "#fdbb84", "#bcbddc"


def main(argv=None) -> str:
    parser = study_parser("Figure 1: phase portraits, on the ionflux_torch "
                          "port.")
    parser.add_argument("--s1", action="store_true",
                        help="the figure-1-s1 variant")
    parser.add_argument("--s2", action="store_true",
                        help="the figure-1-s2 variant")
    args = parse(parser, argv)
    view, v_hi = (30, -125), 60.0
    if args.s1:
        out_name, fig_name = "figure-1-s1", "fig1-s1.png"
        cases = [("pr3-cell5", PR3_COLOR, "Pr3"),
                 ("pr4-cell5", PR5_COLOR, "Pr4")]
    elif args.s2:
        out_name, fig_name = "figure-1-s2", "fig1-s2.png"
        cases = [("sinewave-cell5", PR3_COLOR, "Sinusoidal"),
                 ("aps-cell5", PR5_COLOR, "APs")]
        view, v_hi = (20, -95), 75.0
    else:
        out_name, fig_name = "figure-1", "fig1.png"
        cases = [("pr3-cell5", PR3_COLOR, "Pr3"),
                 ("pr5-cell5", PR5_COLOR, "Pr5")]
    out = outdir(args, f"{out_name}-torch")

    from ionflux_torch.figures import phase_portrait_figure

    path = os.path.join(out, fig_name)
    with traced(args, out):
        phase_portrait_figure(path, cases, out, cached=args.cached,
                              view=view, v_hi=v_hi, device=args.device)
    return path


if __name__ == "__main__":
    main()
    sys.exit(0)
