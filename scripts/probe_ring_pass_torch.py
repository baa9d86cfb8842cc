#!/usr/bin/env python
"""Where the population launches' layer pass spends its time: time the trip
kernel of ``csrc/fused_solve.cu`` and variants of that source on the card.

    python3 scripts/probe_ring_pass_torch.py [VARIANT ...] [--reps 3]

Each variant is a text substitution in the kernel source (and, for the
stage layout, in the wrapper's constants), built under its own hash in
``ionflux_torch/_build/`` and run in a process of its own:

- ``source``: the source as it stands;
- ``no-products``: the f32 FMAs and the bf16 ``mma.sync`` left out, so a trip
  costs the weight copies, the chunk handovers and the rest of the trip
  (its results are wrong, and it may execute other trips);
- ``four-row-tiles``: f32 thread tiles of 4 rows x 4 columns instead of 2 x 4;
- ``every-row``: the padded rows of the popsweep's Q computed too, instead
  of copied from the last real row (the records are the same);
- ``stages-4x48k``: four ring stages of at most 48 KB instead of three of 64.

The launches are chip_smoke.py's (c), (m) and (k) and the first 32 members
of (c), 4096 trips each.  Prints one JSON line per variant: ms per executed
trip, executed trips and n_acc of each launch (CUDA events, mean of
``--reps`` launches after a warm-up), the kernel's registers from ptxas and
the card's name and power limit.  Without a card it exits with an error.
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

_F32_LOOP = "if (!on[i]) continue;\n        tile_f32"
_MMA_LOOP = "for (int s = 0; s < steps; ++s) {"
_TILE = "return RT == 1 ? 1 : 2;"
_STAGES = "constexpr int kStages = 3;"

# variant -> (source substitutions, wrapper constants, every row)
VARIANTS = {
    "source": ([], {}, False),
    "no-products": ([(_F32_LOOP, "if (!on[i] || k0 >= 0) continue;\n"
                                 "        tile_f32"),
                     (_MMA_LOOP, "for (int s = 0; s < 0 * steps; ++s) {")],
                    {}, False),
    "four-row-tiles": ([(_TILE, "return RT == 1 ? 1 : (RT == 8 ? 2 : 4);")],
                       {}, False),
    "every-row": ([], {}, True),
    "stages-4x48k": ([(_STAGES, "constexpr int kStages = 4;")],
                     {"RING_STAGES": 4, "RING_STAGE_BYTES": 49152}, False),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(variant: str, reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_ring_pass_torch: no CUDA device")
    sys.path.insert(0, ROOT)
    from ionflux_torch import protocols as P
    from ionflux_torch.models import nn as N
    from ionflux_torch.models.registry import HH_B06
    from ionflux_torch.ops import _build
    from ionflux_torch.ops import fused_solve as F
    from ionflux_torch.utils.ckpt import params_from_leaves, params_to_leaves

    subs, consts, every_row = VARIANTS[variant]
    with open(_build.SOURCES["fused_solve"]) as fh:
        src = fh.read()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{variant}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    if subs:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        path = os.path.join(_build.BUILD_DIR, f"fused_solve_{variant}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        _build.SOURCES["fused_solve"] = path
    for name, value in consts.items():
        setattr(F, name, value)
    log = _build.load_library("fused_solve").build_log
    regs, kernel = {}, ""
    for line in log.splitlines():   # ptxas: registers per trip_kernel<...>
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line and "trip_kernel" in kernel:
            name = kernel.split("trip_kernel")[1].split("EEv")[0]
            regs[name] = int(line.split("Used")[1].split()[0])

    C = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    d1_path = os.path.join(ROOT, "out", "d1", "model.npz")
    pop = params_from_leaves(C.population(C.npz_leaves(d1_path), C.P_POP, 0),
                             "nnf", dev)
    wide = N.nnf_init(torch.Generator().manual_seed(0), HH_B06, 5, 200,
                      device=dev)
    popw = params_from_leaves(
        C.population(params_to_leaves(wide), C.P_POP, 0), "nnf", dev)
    deact = P.deactivation_family(0.1, device=dev)
    b_d, ts_d = P.stack(deact), deact[0].times()
    act20 = P.activation_protocol(20.0, 0.1, device=dev)

    def popsweep(nets, rgate, bf16):
        return F._popsweep_setup(nets, rgate, b_d.v, ts_d, 0.0, 0.1,
                                 float(ts_d[-1]), 1e-5, 1e-7, C.TRIPS, None,
                                 None, True, bf16, 1)

    setups = {
        "B1 (c)": popsweep(pop.net, pop.rgate, False),
        "B1 (c) P=32": popsweep([(w[:32], b[:32]) for w, b in pop.net.layers],
                                pop.rgate, False),
        "B1 bf16 (m)": popsweep(popw.net, popw.rgate, True),
        "B4 (k)": F._pop_setup(pop.net.layers, pop.rgate, act20.v,
                               act20.times(), 0.0, 0.1,
                               float(act20.times()[-1]), 1e-5, 1e-7,
                               C.TRIPS)}
    out = {}
    for name, s in setups.items():
        if every_row:
            s = dataclasses.replace(s, q_real=0)
        ms, res = C.cuda_ms(lambda s=s: F._trip_solve_cuda(s), reps)
        n_acc, n_valid = (int(x) for x in res[3])
        out[name] = {"ms_per_trip": ms / n_valid, "n_valid": n_valid,
                     "n_acc": n_acc}
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
        # one process per variant: a process loads one build of the kernel
        for v in args.variants:
            subprocess.run([sys.executable, os.path.abspath(__file__), v,
                            "--reps", str(args.reps)], check=True)
