#!/usr/bin/env python
"""Where the sweeps' cluster layer pass spends its time: time the sweep
kernels of ``csrc/fused_solve.cu`` and variants of that source on the card.

    python3 scripts/probe_cluster_pass_torch.py [VARIANT ...] [--reps 3]

Each variant is a text substitution in the kernel source (or a cluster
size), built under its own name and hash in ``ionflux_torch/_build/`` (all
variants' nvcc processes started together) and run in a process of its
own:

- ``source``: the source as it stands (clusters of 8);
- ``c16``: the source on clusters of 16 blocks;
- ``no-chains``: the hidden layers' fmaf chains left out (each output is
  its bias), so a trip costs the exchanges, the last layer and the rest;
- ``local-push``: each block stores its outputs into its own shared memory
  only, not its peers' (no DSMEM traffic; the barriers stay);
- ``no-barrier``: the cluster barrier after each exchange left out;
- ``cols-1``: thread tasks of 2 rows x 1 column instead of 2 x 2;
- ``rows-1``: tasks of 1 row x 2 columns at 8-row tiles (the sweeps'
  B = 7) instead of 2 x 2;
- ``exchange-layer-0``: layer 0 sliced over the blocks and exchanged like
  the hidden layers, instead of computed whole in every block;
- ``unroll-8``, ``unroll-16``: the chains' k loop unrolled 8 or 16 times
  instead of 32;
- ``rows-2-at-32``: tasks of 2 rows x 2 columns at 32-row tiles (B > 16,
  such as (b')) instead of 4 x 2.

The last six give the source's records (each output's sum keeps its
order).
``no-chains``, ``local-push`` and ``no-barrier`` give wrong results and may
execute other trips; compare per executed trip.  The launches are chip_smoke.py's (b) and (b') for B2 (d1,
B = 7 and 40) and (l) for B6.  Prints one JSON line per variant: ms per
executed trip (step), executed trips and n_acc of each launch (CUDA events,
mean of ``--reps`` launches after a warm-up), the sweep kernels' registers
from ptxas and the card's name and power limit.  Without a card it exits
with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHAIN = ("        for (int k = 0; k < din; ++k) {\n"
          "          float w[TC], x[TR];")
_PUSH = "  for (int q = 0; q < csize; ++q) {\n    uint32_t r;"
_BARRIER = "        cluster_barrier();\n        ++n_ex;"
_TR = "constexpr int cluster_tr() { return RT < 32 ? 2 : 4; }"
_TC = "constexpr int kClusterCols = 2;"
_WHOLE = "const bool whole = l == 0 || dout == 1;"
_UNROLL = "#pragma unroll 32\n        for (int k = 0; k < din; ++k) {"


def _geometry_exchanging_layer_0(sizes, csize):
    """ops/fused_solve.py::cluster_geometry with layer 0 sliced like a
    hidden layer."""
    geom, off = [], 0
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        cols = -(-d_out // csize)
        cols = 1 if d_out == 1 else cols + cols % 2
        geom.append((off, cols))
        off += -(-(d_in + 1) * cols // 4) * 4
    return geom, off


# variant -> (source substitutions, blocks per cluster, attributes of
# ops/fused_solve.py to replace)
VARIANTS = {
    "source": ([], 8, {}),
    "c16": ([], 16, {}),
    "no-chains": ([(_CHAIN, _CHAIN.replace("k < din", "k < 0 * din"))], 8,
                  {}),
    "local-push": ([(_PUSH, _PUSH.replace(
        "q = 0; q < csize", "q = blockIdx.x % csize; q == blockIdx.x % csize"
    ))], 8, {}),
    "no-barrier": ([(_BARRIER, _BARRIER.replace("cluster_barrier",
                                                "__syncthreads"))], 8, {}),
    "cols-1": ([(_TC, _TC.replace("2", "1"))], 8, {"CLUSTER_COLS": 1}),
    "rows-1": ([(_TR, _TR.replace("RT < 32", "RT == 8 ? 1 : RT < 32"))], 8,
               {}),
    "exchange-layer-0": ([(_WHOLE, _WHOLE.replace("l == 0 || ", ""))], 8,
                         {"cluster_geometry": _geometry_exchanging_layer_0}),
    "unroll-8": ([(_UNROLL, _UNROLL.replace("32", "8"))], 8, {}),
    "unroll-16": ([(_UNROLL, _UNROLL.replace("32", "16"))], 8, {}),
    "rows-2-at-32": ([(_TR, _TR.replace("RT < 32 ? 2 : 4", "2"))], 8, {}),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _register(variant: str) -> str:
    """Write the variant's source and name its library; returns the name."""
    from ionflux_torch.ops import _build

    subs = VARIANTS[variant][0]
    if not subs:
        return "fused_solve"
    with open(_build.SOURCES["fused_solve"]) as fh:
        src = fh.read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{variant}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    name = "fused_solve_" + variant.replace("-", "_")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, name + ".cu")
    with open(path, "w") as fh:
        fh.write(src)
    _build.SOURCES[name] = path
    _build._SIGNATURES[name] = _build._SIGNATURES["fused_solve"]
    return name


def run(variant: str, reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_cluster_pass_torch: no CUDA device")
    sys.path.insert(0, ROOT)
    from ionflux_torch import protocols as P
    from ionflux_torch.ops import _build
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.utils.ckpt import load_pytree

    name = _register(variant)
    csize, attrs = VARIANTS[variant][1:]
    for attr, value in attrs.items():
        setattr(F, attr, value)
    launch = _build.launch
    _build.launch = lambda lib, *a: launch(
        name if lib == "fused_solve" else lib, *a)
    log = _build.load_library(name).build_log
    regs, kernel = {}, ""
    for line in log.splitlines():   # ptxas: registers per sweep kernel
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line and ("Li2EEEv" in kernel
                                      or "Li0EEEv" in kernel):
            short = kernel.split("_kernelI")
            regs[short[0][-5:] + short[1].split("EEEv")[0]] = int(
                line.split("Used")[1].split()[0])

    C = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    d1 = load_pytree(os.path.join(ROOT, "out", "d1", "model.npz"), "nnf",
                     device=dev)
    act = P.activation_family(0.1, device=dev)
    b_a, ts_a = P.stack(act), act[0].times()
    v40 = torch.full((C.B40, 10001), -80.0, device=dev)
    v40[:, 1000:] = torch.linspace(-60.0, 60.0, C.B40, device=dev)[:, None]
    ts40 = torch.arange(0, 10001, 10, device=dev).float() * 0.1
    setups = {
        "B2 (b)": F._sweep_setup(d1.net, d1.rgate, b_a.v, ts_a, 0.0, 0.1,
                                 float(ts_a[-1]), 1e-6, 1e-8, C.TRIPS, None),
        "B2 (b') B=40": F._sweep_setup(
            d1.net, d1.rgate, v40, ts40, 0.0, 0.1, 1000.0,
            C.B40_TOL["rtol"], C.B40_TOL["atol"], C.B40_TRIPS, None),
        "B6 (l)": F._sweep_setup(
            d1.net, d1.rgate, b_a.v, ts_a, 0.0, 0.1, float(ts_a[-1]),
            C.WHILE["rtol"], C.WHILE["atol"], C.WHILE["max_rec"], None,
            block=1)}
    out = {}
    for label, s in setups.items():
        s = dataclasses.replace(s, cluster=csize)
        if label.startswith("B6"):
            ms, res = C.cuda_ms(lambda s=s: F._while_solve_cuda(
                s, C.WHILE["max_steps"]), reps)
        else:
            ms, res = C.cuda_ms(lambda s=s: F._trip_solve_cuda(s), reps)
        n_acc, n_valid = (int(x) for x in res[3])
        out[label] = {"ms_per_trip": ms / max(n_valid, 1),
                      "n_valid": n_valid, "n_acc": n_acc}
    line = {"variant": variant, "card": C.device_line(), "launches": out,
            "registers": regs}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if len(args.variants) == 1:
        run(args.variants[0], args.reps)
    else:
        # build every variant at once, then one process per variant
        sys.path.insert(0, ROOT)
        from ionflux_torch.ops import _build
        _build.build(sorted({_register(v) for v in args.variants}))
        failed = [v for v in args.variants if subprocess.run(
            [sys.executable, os.path.abspath(__file__), v, "--reps",
             str(args.reps)]).returncode]
        if failed:
            raise SystemExit(f"variants that failed: {failed}")
