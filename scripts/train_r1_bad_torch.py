#!/usr/bin/env python
"""Study r1-bad on the ionflux_torch port: NN-f trained on insufficient
protocols (Pr3+Pr4 only), the negative control of figures 6 and 7, as
``train_r1_torch.py`` runs r1 (``rstudies.run_real_study``; ``--pred``:
``rstudies.predict_real_study``).

Reads ``IONFLUX_REFERENCE/r1-bad/`` (and ``r1/`` for validation); writes to
--outdir (default out/r1-bad-torch)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import real_study_main  # noqa: E402


def main(argv=None):
    from ionflux_torch.rstudies import R1BAD

    return real_study_main(R1BAD, "IKr real data fit with NN-f, "
                                  "insufficient protocols (r1-bad), on the "
                                  "ionflux_torch port.", argv)


if __name__ == "__main__":
    main()
    sys.exit(0)
