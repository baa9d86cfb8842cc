#!/usr/bin/env python
"""Study r1 on the ionflux_torch port: NN-f on the real Beattie-2018 cell-5
data (the 5 x 200 net on the Pr3+Pr5 derivative surface), pretrained on
the cell-5 a-gate surface, 16,000 Adam updates in 400-update chunks, each
checkpoint scored on Pr5 against the measured current
(``rstudies.run_real_study``).

    python3 scripts/train_r1_torch.py --iters 800
    python3 scripts/train_r1_torch.py --pred --outdir out/r1

Reads the reference's surface caches under ``IONFLUX_REFERENCE`` (``r1/``,
``r1-bad/`` for --pred's Pr4 row, ``table-2/`` for its sinewave and APs
rows), or the raw CSVs under ``<repo>/data``.  Runs on the card unless
``--device cpu`` is given; writes model.npz, best-model.npz and the
checkpoints to --outdir (default out/r1-torch)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import real_study_main  # noqa: E402


def main(argv=None):
    from ionflux_torch.rstudies import R1

    return real_study_main(R1, "IKr real data fit with NN-f (r1), on the "
                               "ionflux_torch port.", argv)


if __name__ == "__main__":
    main()
    sys.exit(0)
