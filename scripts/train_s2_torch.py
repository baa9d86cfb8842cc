#!/usr/bin/env python
"""Study s2 on the ionflux_torch port: NN-d (a discrepancy MLP on the
candidate HH model) on synthetic no-discrepancy data: init std 1e-3, no
pretrain, the residual as training target, checkpoint validation over 4
init seeds on the s-study prediction rollouts (``studies.s_rollout_maes``,
which needs ``test-protocols/ap2hz.csv`` under ``IONFLUX_REFERENCE``).
Where ``<outdir>/../s1/model.npz`` exists, its net's loss on this surface
is printed as "Target Loss".

    python3 scripts/train_s2_torch.py --iters 800
    python3 scripts/train_s2_torch.py --pred --outdir out/s2

Runs on the card unless ``--device cpu`` is given; writes model.npz,
model-entire.npz and surface.npz to --outdir (default out/s2-torch)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import study_main  # noqa: E402


def main(argv=None):
    from ionflux_torch.studies import S2, s_rollout_maes

    return study_main(S2, 4, "IKr simple syn. fit with NN-d (s2), on the "
                             "ionflux_torch port.", argv,
                      metric=s_rollout_maes, target_from="s1")


if __name__ == "__main__":
    main()
    sys.exit(0)
