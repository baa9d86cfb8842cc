#!/usr/bin/env python
"""Study d2 on the ionflux_torch port: NN-d under model discrepancy (ground
truth the 3-state Markov model), trained on the derivative surface with
checkpoint validation over 6 init seeds (``studies.run_study_validated``).

    python3 scripts/train_d2_torch.py --iters 800

Runs on the card unless ``--device cpu`` is given; writes model.npz,
model-entire.npz and surface.npz to --outdir (default out/d2-torch)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import study_main  # noqa: E402


def main(argv=None) -> int:
    from ionflux_torch.studies import D2

    return study_main(D2, 6, "IKr syn. discrepancy fit with NN-d (d2), on "
                             "the ionflux_torch port.", argv)


if __name__ == "__main__":
    sys.exit(main())
