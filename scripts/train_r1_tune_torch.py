#!/usr/bin/env python
"""Study r1-tune on the ionflux_torch port: NN-f architecture sweep on the
real cell-5 data (the registry's ``ARCHITECTURES``, s00-s11).

    python3 scripts/train_r1_tune_torch.py --info s03 --iters 400
    python3 scripts/train_r1_tune_torch.py --all [--pred]

``--info sNN`` trains one architecture (s00 by default), ``--all`` all
twelve, each into <outdir>/<sNN> (default out/r1-tune-torch/<sNN>) by
``rstudies.run_real_study``; ``--pred`` replays each instead.  Returns
{arch_id: result}."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import outdir, parse, study_parser, traced  # noqa: E402


def main(argv=None):
    import torch

    from ionflux_torch import rstudies as R
    from ionflux_torch.models.registry import ARCHITECTURES

    parser = study_parser("IKr real data fit with NN-f, tunable arch "
                          "(r1-tune), on the ionflux_torch port.", real=True)
    parser.add_argument("--all", action="store_true",
                        help="sweep all 12 architectures")
    args = parse(parser, argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = outdir(args, "r1-tune-torch")
    ids = list(ARCHITECTURES) if args.all else [args.info or "s00"]
    results = {}
    with traced(args, out):
        for arch_id in ids:
            print(f"=== architecture {arch_id} "
                  f"(n_layers={ARCHITECTURES[arch_id][0]}, "
                  f"n_nodes={ARCHITECTURES[arch_id][1]}) ===")
            spec = R.tune_study(arch_id)
            sub = os.path.join(out, arch_id)
            if args.pred:
                results[arch_id] = R.predict_real_study(spec, sub,
                                                        device=args.device)
            else:
                results[arch_id] = R.run_real_study(
                    spec, sub, iters=args.iters, smoothi=args.smoothi,
                    device=args.device)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
