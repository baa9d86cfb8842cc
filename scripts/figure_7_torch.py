#!/usr/bin/env python
"""Figure 7 on the ionflux_torch port (``scripts/figure_7.py``): the
(V, a)-plane coverage of the r1-bad model, the unidentifiability picture.
Panel A: the a-gate trajectories that the Pr3 + Pr4 training protocols
explore; panel B adds Pr5 (yellow), whose -70 to -40 mV test steps (red)
probe where the training data never went.  On the recorded cell-5
protocols, by the chained solve.

The model is the final r1-bad net, out/r1-bad/model.npz (committed), or
with ``--oracle`` (or without that file) the reference's archived
``r1-bad/model-state-dict.pt`` under ``IONFLUX_REFERENCE``.

    python3 scripts/figure_7_torch.py [--oracle] [--cached] [--device cpu]

writes <outdir>/fig7.png (default out/figure-7-torch; matplotlib) and the
trajectories a1-<name>[-o].npz; returns {name: a at every sample}."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import (ROOT, drawing, outdir, parse,  # noqa: E402
                          study_parser, traced)

NAMES = ("pr3", "pr4", "pr5")
PR5_RED = (-70.0, -60.0, -50.0, -40.0)


def load_model(oracle: bool, device):
    """The r1-bad NN-f: the committed final model, or the reference's."""
    from ionflux_torch.figures import _reference_file, _reference_net
    from ionflux_torch.models.nn import NNfParams
    from ionflux_torch.models.registry import HH_R1BAD_INIT
    from ionflux_torch.utils.ckpt import load_pytree

    ours = os.path.join(ROOT, "out", "r1-bad", "model.npz")
    if oracle or not os.path.exists(ours):
        return NNfParams(net=_reference_net(_reference_file(
            None, "r1-bad/model-state-dict.pt"), device),
            rgate=HH_R1BAD_INIT)
    return load_pytree(ours, "nnf", device)


def plot_cov(ax, name, v, a, alpha, v_shift=0.0, red_tests=()):
    bounds = np.concatenate([np.flatnonzero(np.diff(v) != 0) + 1, [len(v)]])
    i, first = 0, True
    for f in bounds:
        red = (f - i > 10000) and any(abs(v[i] - tv) < 0.5
                                      for tv in red_tests)
        color = "C3" if red else ("#deb466" if name == "pr5" else "#878ad4")
        ax.plot(v[i:f] + v_shift, a[i:f], alpha=0.95 * alpha, color=color,
                label="__nolegend__" if not first else name.capitalize())
        ax.scatter(v[i] + v_shift, a[i], alpha=alpha, color=color,
                   marker=".")
        ax.scatter(v[f - 1] + v_shift, a[f - 1], alpha=alpha, color=color,
                   marker=".")
        first = False
        i = f


def draw(path: str, vs: dict, traj: dict) -> None:
    from ionflux_torch.figures import _pyplot

    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, sharey=True, figsize=(9, 3.5))
    for name in ("pr3", "pr4"):
        plot_cov(axes[0], name, vs[name], traj[name], 1.0, v_shift=-0.6)
        plot_cov(axes[1], name, vs[name], traj[name], 0.3, v_shift=-0.6)
    plot_cov(axes[1], "pr5", vs["pr5"], traj["pr5"], 1.0, v_shift=+0.6,
             red_tests=PR5_RED)
    # the steady-state envelope (figure-7.py:440-448)
    y1 = [0.005, 0.354, 0.549, 0.822, 0.995, 0.995]
    x1 = [-120, -100, -90, -80, -60, 20]
    y2 = [0.005, 0.005, 0.005, 0.005, 0.01, 0.075, 0.243, 0.651, 0.995]
    x2 = [-120, -100, -90, -80, -60, -40, -20, 0, 20]
    for ax, alpha in zip(axes, (0.5, 0.25)):
        ax.plot(x1, y1, "--", c="#7f7f7f", alpha=alpha)
        ax.plot(x2, y2, "--", c="#7f7f7f", alpha=alpha)
    axes[0].set_ylabel(r"$a$")
    for k, ax in enumerate(axes):
        ax.set_xlabel(r"$V$ (mV)")
        ax.set_ylim(0, 1)
        ax.text(-0.1 if k == 0 else -0.025, 1.05, f"({chr(65 + k)})",
                size=12, weight="bold", va="bottom", ha="right",
                transform=ax.transAxes)
    plt.tight_layout()
    plt.savefig(path, pad_inches=0.02, dpi=200, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None) -> dict:
    parser = study_parser("Figure 7: r1-bad coverage analysis, on the "
                          "ionflux_torch port.")
    parser.add_argument("--oracle", action="store_true",
                        help="the reference's archived r1-bad weights")
    args = parse(parser, argv)
    out = outdir(args, "figure-7-torch")

    import torch

    from ionflux_torch import protorec
    from ionflux_torch._device import resolve_device
    from ionflux_torch.eval import solve_states_long

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    traj, vs = {}, {}
    with traced(args, out):
        params = load_model(args.oracle, device)
        y0 = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)
        for name in NAMES:
            vs[name] = protorec.load_voltage(f"{name}-cell5")[0]
            cache = os.path.join(
                out, f"a1-{name}{'-o' if args.oracle else ''}.npz")
            if args.cached and os.path.exists(cache):
                with np.load(cache) as z:
                    traj[name] = z["a"]
                continue
            traj[name] = solve_states_long(
                "nnf", params, f"{name}-cell5", y0)[:, 0].double().cpu(
                ).numpy()
            np.savez(cache, a=traj[name])
        path = os.path.join(out, "fig7.png")
        if drawing(path):
            draw(path, vs, traj)
    return traj


if __name__ == "__main__":
    main()
    sys.exit(0)
