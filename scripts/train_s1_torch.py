#!/usr/bin/env python
"""Study s1 on the ionflux_torch port: NN-f on synthetic no-discrepancy
data (the ground truth is the candidate HH model), pretrained on its a-gate
surface, trained on the derivative surface with checkpoint validation over
4 init seeds on the s-study prediction rollouts (``studies.s_rollout_maes``,
which needs ``test-protocols/ap2hz.csv`` under ``IONFLUX_REFERENCE``).

    python3 scripts/train_s1_torch.py --iters 800
    python3 scripts/train_s1_torch.py --pred --outdir out/s1

Runs on the card unless ``--device cpu`` is given; writes model.npz,
model-entire.npz and surface.npz to --outdir (default out/s1-torch).
``--pred`` replays <outdir>/model.npz on every prediction protocol
(``studies.predict_study``) and returns its MAEs."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import study_main  # noqa: E402


def main(argv=None):
    from ionflux_torch.studies import S1, s_rollout_maes

    return study_main(S1, 4, "IKr simple syn. fit with NN-f (s1), on the "
                             "ionflux_torch port.", argv,
                      metric=s_rollout_maes)


if __name__ == "__main__":
    main()
    sys.exit(0)
