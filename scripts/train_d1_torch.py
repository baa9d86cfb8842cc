#!/usr/bin/env python
"""Study d1 on the ionflux_torch port: NN-f under model discrepancy (ground
truth the 3-state Markov model), pretrained on the Markov a-gate surface,
trained on the derivative surface with checkpoint validation over 4 init
seeds (``studies.run_study_validated``).

    python3 scripts/train_d1_torch.py --iters 800
    python3 scripts/train_d1_torch.py --pred --outdir out/d1

Runs on the card unless ``--device cpu`` is given; writes model.npz,
model-entire.npz and surface.npz to --outdir (default out/d1-torch).
``--pred`` replays <outdir>/model.npz on every prediction protocol
(``studies.predict_study``; needs ``test-protocols/ap2hz.csv`` under
``IONFLUX_REFERENCE``) and returns its MAEs; training returns the kept
params."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import study_main  # noqa: E402


def main(argv=None):
    from ionflux_torch.studies import D1

    return study_main(D1, 4, "IKr syn. discrepancy fit with NN-f (d1), on "
                             "the ionflux_torch port.", argv)


if __name__ == "__main__":
    main()
    sys.exit(0)
