"""The command line of the ionflux_torch study scripts
(``train_d1_torch.py``, ``train_d2_torch.py``, ``train_neural_ode_torch.py``):
the JAX scripts' flags (``scripts/common.py``) but for ``--pred`` and
``--debug`` (their prediction replay and plots are not ported), with
``--device`` in place of ``--platform``.  ``--method`` sets the solver
method of every ``eval.simulate`` in the run (``eval.DEFAULT_METHOD``)."""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def study_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--method", type=str, default="dopri5",
                   choices=["dopri5", "adams", "vcabm", "rosenbrock"])
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--cached", action="store_true",
                   help="reuse <outdir>/surface.npz if it is there")
    p.add_argument("--iters", type=int, default=None,
                   help="override the main training iterations")
    p.add_argument("--outdir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p


def parse(parser: argparse.ArgumentParser, argv=None):
    """The parsed flags; --method becomes ``eval.DEFAULT_METHOD``, as the
    JAX scripts' ``setup`` does."""
    args = parser.parse_args(argv)
    if args.method != "dopri5":
        from ionflux_torch import eval as E

        E.DEFAULT_METHOD = args.method
        print(f"solver method: {args.method}")
    return args


def study_main(spec, n_seeds: int, description: str, argv=None) -> int:
    """Parse the flags and run ``studies.run_study_validated(spec)`` into
    --outdir (default out/<name>-torch)."""
    args = parse(study_parser(description), argv)
    if args.adjoint:
        print("--adjoint ignored: study training never differentiates "
              "through a solve; scripts/train_neural_ode_torch.py runs the "
              "adjoint path")
    import torch

    from ionflux_torch.studies import run_study_validated

    torch.backends.cuda.matmul.allow_tf32 = False
    outdir = args.outdir or os.path.join(ROOT, "out", f"{spec.name}-torch")
    os.makedirs(outdir, exist_ok=True)
    run_study_validated(spec, outdir, n_seeds=n_seeds, iters=args.iters,
                        cached=args.cached, device=args.device)
    return 0
