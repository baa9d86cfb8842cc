#!/usr/bin/env python
"""Time the Mosaic-probe kernel (``ops/bias_probe.py::bias_probe``) of one
checkout of ``ionflux_torch`` on the card, three ways, to compare two
commits inside one run.

    python3 scripts/time_probe_torch.py [--root DIR] [--reps 200]

``--root`` names the checkout whose ``ionflux_torch`` is timed (default:
this one); its kernel is built there at first use.  The inputs are the
probe script's (P = 64, Q = M = 16, 64 trips, ``RandomState(0)``).  For the
``bias`` and ``fold`` cases it prints one JSON line with the card's name and
power limit and, per case:

- ``us_eager``: CUDA events around ``--reps`` back-to-back calls of the
  wrapper, per call; a kernel shorter than the wrapper's host work is timed
  at the rate the host issues the calls;
- ``us_graph``: the same calls captured in one CUDA graph, the replay timed
  by CUDA events, per call: kernels back to back with no host work;
- ``us_kernel``: the profiler's device time of the kernel, per launch;
- ``sha256``: a hash of the output (equal hashes: identical results).

To compare a parent with a change, run parent, change, change, parent in
one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def probe_times(dev, fold: bool, reps: int) -> dict:
    """The three per-call times (us) and the output hash of one case."""
    from torch.profiler import ProfilerActivity, profile

    from ionflux_torch.ops.bias_probe import bias_probe

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import probe_mosaic_bias_fault_torch as PR

    w, b = PR.probe_inputs(dev)
    out = bias_probe(w, b, fold=fold)           # build, load, warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        bias_probe(w, b, fold=fold)
    end.record()
    end.synchronize()
    us_eager = start.elapsed_time(end) * 1e3 / reps

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            bias_probe(w, b, fold=fold)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    us_graph = start.elapsed_time(end) * 1e3 / reps

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bias_probe(w, b, fold=fold)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if "bias_probe" in e.key]
    us_kernel = (sum(e.self_device_time_total for e in kern)
                 / max(1, sum(e.count for e in kern))) if kern else None
    return dict(us_eager=us_eager, us_graph=us_graph, us_kernel=us_kernel,
                sha256=hashlib.sha256(out.cpu().numpy().tobytes())
                .hexdigest())


def main(root: str, reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("time_probe_torch: no CUDA device")
    sys.path.insert(0, os.path.abspath(root))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    row = dict(root=os.path.abspath(root), card=_card())
    for case in ("bias", "fold"):
        row[case] = probe_times(dev, case == "fold", reps)
    return row


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose ionflux_torch is timed")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    print(json.dumps(main(args.root, args.reps)), flush=True)
