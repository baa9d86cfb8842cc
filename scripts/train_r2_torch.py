#!/usr/bin/env python
"""Study r2 on the ionflux_torch port: NN-d on the real cell-5 data (the
5 x 200 residual net over the cell-5 HH fit, no E shift), as
``train_r1_torch.py`` runs r1 (``rstudies.run_real_study``; ``--pred``:
``rstudies.predict_real_study``).

    python3 scripts/train_r2_torch.py --pred --outdir out/r2

Reads ``IONFLUX_REFERENCE/r2/`` (and ``r1/``, ``r1-bad/`` for validation);
writes to --outdir (default out/r2-torch)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import real_study_main  # noqa: E402


def main(argv=None):
    from ionflux_torch.rstudies import R2

    return real_study_main(R2, "IKr real data fit with NN-d (r2), on the "
                               "ionflux_torch port.", argv)


if __name__ == "__main__":
    main()
    sys.exit(0)
