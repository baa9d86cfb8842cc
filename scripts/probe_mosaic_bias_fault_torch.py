"""The Mosaic bias-fault probe of ``scripts/probe_mosaic_bias_fault.py``,
through the port (``ionflux_torch.ops.bias_probe``).

On the TPU the ``bias`` case coredumped the Mosaic compiler and the
``fold`` case (the bias as a third weight row) ran.  On the card both cases
run as one hand-written CUDA kernel and compute the same function:

    python scripts/probe_mosaic_bias_fault_torch.py bias
    python scripts/probe_mosaic_bias_fault_torch.py fold
    python scripts/probe_mosaic_bias_fault_torch.py fold --device cpu

Same shapes and inputs as the JAX script: P = 64 members, Q = 16 rows, M =
16 columns, 64 trips, w = 0.1 randn(P, 3, M) and b = 0.1 randn(P, M) from
``numpy.random.RandomState(0)``.  Runs on the card unless ``--device cpu``
asks for the plain version on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ionflux_torch._device import resolve_device  # noqa: E402
from ionflux_torch.ops.bias_probe import bias_probe  # noqa: E402

P, M = 64, 16


def probe_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """w [P, 3, M] and b [P, M], as the JAX script draws them."""
    rng = np.random.RandomState(0)
    w = (rng.randn(P, 3, M) * 0.1).astype(np.float32)
    b = (rng.randn(P, M) * 0.1).astype(np.float32)
    return (torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))


def main(case: str = "bias", device=None) -> torch.Tensor:
    if case not in ("bias", "fold"):
        raise ValueError(f"case must be 'bias' or 'fold', got {case!r}")
    dev = resolve_device(device)
    out = bias_probe(*probe_inputs(dev), fold=case == "fold")
    print(case, "OK", float(out[0, 0]))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", nargs="?", default="bias",
                    choices=("bias", "fold"))
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain version; default the card")
    args = ap.parse_args()
    main(args.case, args.device)
