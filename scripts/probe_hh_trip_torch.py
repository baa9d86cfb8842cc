#!/usr/bin/env python
"""Where the HH population trip kernel (B3) spends a trip: time the trip
kernel of ``csrc/hh_solve.cu`` and variants of it on the card.

    python3 scripts/probe_hh_trip_torch.py [VARIANT ...] [--reps 20]

Variants:

- ``source``: the source as it stands, at the layout rule's helper threads
  per lane (``ops.hh_solve.hh_trip_geometry``); it also times the RK4 kernel
  (B5) at its 2 lanes per block;
- ``g1``, ``g4``, ``g8``, ``g32``: the trip kernel's launch forced to 1, 4,
  8 or 32 helper threads per lane (one computes all 20 rates of its lane;
  32 leave 12 idle), where they fit the block;
- ``rk4-lanes1``, ``rk4-lanes4``: the RK4 kernel at 1 or 4 lanes per block
  (``kRk4Lanes``);
- ``no-records``: the records' copies to device memory left out (timing
  only: the records are not written);
- ``f64-div-sqrt``: the error norm's divisions and square root in f64,
  rounded once to f32 (f64 has more than twice f32's precision, so each
  f32 result is the correctly rounded one, as the intrinsics': the records
  must hash the same), which have no slow path for tiny f32 operands;
- ``fast-div-sqrt``: the same with the approximate f32 divide and sqrtf,
  which have no slow path either (timing only: results differ);
- ``cycles``: the source with clock64() counters in the chain warps: SM
  cycles per executed trip waiting for the rates, in the chain up to the
  ratio, in the accept and controller, and at the block end and publishing
  the next voltages (of which the stage voltage's load); with the SM clock
  nvidia-smi reads meanwhile.

The launches are chip_smoke.py's (i): 128 lanes (HH_B06 x exp(0.1 N(0, 1)),
``RandomState(0)``) and the first 8 of them (``cycles`` also 32, 33 and
64: one full chain warp, two, two full) on Pr3 sweep 0 (82,581 knots),
rtol 1e-5, 2048 trips; and (j)'s RK4 at 128 lanes, 10 substeps per 1 ms
output.  A source variant is a text substitution built under its own hash
in ``ionflux_torch/_build/`` and run in a process of its own.  Prints one
JSON line per variant: ms per executed trip, executed trips and a SHA-256
of the records of each launch (CUDA events, mean of ``--reps`` launches
after half a second of them; the layout variants must keep the source's
hashes), the layout each kernel reports for its launch, the trip kernels'
registers and spills from ptxas, and the card's name and power limit.
Without a card it exits with an error.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RECORDS = "if (k > 0 && on) {  // the records of trip k - 1"
_RATES_WAIT = "    named_sync(kRatesReady, n_all);\n"

# The cycles variant: the chain warps' thread 0 sums clock64() deltas over
# the trips (waiting for the rates; the chain to the ratio; the accept and
# the controller; the block end and publishing the next voltages, and of
# that the stage voltage's load and store) and leaves them, as floats, in
# the last 5 slots of rec_sc, which a launch that executes fewer trips than
# its budget never writes.
_CYCLES = [
    ("  bool go = blk < n_blocks && t < a.t_end && any0;\n",
     "  long long cyc[5] = {0, 0, 0, 0, 0};\n"
     "  bool go = blk < n_blocks && t < a.t_end && any0;\n"),
    (_RATES_WAIT, "    const long long c0 = clock64();\n" + _RATES_WAIT
     + "    const long long c1 = clock64();\n"),
    ("    const float ratio = __uint_as_float(m);\n",
     "    const long long c2 = clock64();\n"
     "    const float ratio = __uint_as_float(m);\n"),
    ("    if (j == (size_t)a.block) {",
     "    const long long c3 = clock64();\n"
     "    if (j == (size_t)a.block) {"),
    ("    publish();\n  }\n",
     "    publish();\n    const long long c4 = clock64();\n"
     "    cyc[0] += c1 - c0; cyc[1] += c2 - c1; cyc[2] += c3 - c2;\n"
     "    cyc[3] += c4 - c3;\n  }\n"),
    ("      float x = voltage(a.vpad, hi, a.t0, a.inv_dt,\n"
     "                        add(t, mul(c_lane, h_eff)));\n",
     "      cyc[4] -= clock64();\n"
     "      float x = voltage(a.vpad, hi, a.t0, a.inv_dt,\n"
     "                        add(t, mul(c_lane, h_eff)));\n"
     "      sink[wl] = x;\n"
     "      __threadfence_block();\n"
     "      cyc[4] += clock64();\n"),
    ("  if (chain) a.alive_out[lane] = alive ? 1 : 0;",
     "  if (tid == 0)\n    for (int q = 0; q < 5; ++q)\n"
     "      a.rec_sc[(size_t)a.trips * 2 - 5 + q] = (float)cyc[q];\n"
     "  if (chain) a.alive_out[lane] = alive ? 1 : 0;"),
]
CYCLE_PHASES = ("wait for rates", "chain to ratio", "accept, controller",
                "block end, publish", "of which the voltage load")

_THREADS = ("  const int threads = (b + 31) / 32 * 32 + (b * group + 31) / 32"
            " * 32;\n")
_CASES = "    case 20: hh_trip_kernel<20>"
_RK4_LANES = "constexpr int kRk4Lanes = 2;"


def _group(g: int) -> list:
    """The trip kernel launched at g helper threads per lane, whatever the
    rule picks (with a build of it where the rule has none)."""
    subs = [(_THREADS, f"  group = {g};\n" + _THREADS)]
    if g not in (20, 10, 5, 4, 3):          # hh_solve.py: TRIP_GROUPS
        subs.append((_CASES, f"    case {g}: hh_trip_kernel<{g}><<<1, "
                     f"threads, 0, s>>>(a); break;\n" + _CASES))
    return subs


# variant -> (source substitutions, helpers per lane forced or None for the
# rule, whether the RK4 kernel is timed too)
VARIANTS = {
    "source": ([], None, True),
    "g1": (_group(1), 1, False),
    "g4": (_group(4), 4, False),
    "g8": (_group(8), 8, False),
    "g32": (_group(32), 32, False),
    "rk4-lanes1": ([(_RK4_LANES, "constexpr int kRk4Lanes = 1;")], None,
                   True),
    "rk4-lanes4": ([(_RK4_LANES, "constexpr int kRk4Lanes = 4;")], None,
                   True),
    "no-records": ([(_RECORDS, "if (k > 0 && on && a.b < 0) {")], None,
                   False),
    "cycles": (_CYCLES, None, False),
    "f64-div-sqrt": (
        [("e[c] = err == 0.f ? 0.f : __fdiv_rn(err, sc[c]);",
          "e[c] = err == 0.f ? 0.f : (float)((double)err / (double)sc[c]);"),
         ("float r = __fsqrt_rn(mul(add(mul(e[0], e[0]), mul(e[1], e[1])), "
          "0.5f));",
          "const float r2 = mul(add(mul(e[0], e[0]), mul(e[1], e[1])), 0.5f);"
          "\n      float r = r2 == 0.f ? 0.f : (float)sqrt((double)r2);")],
        None, False),
    "fast-div-sqrt": (
        [("e[c] = err == 0.f ? 0.f : __fdiv_rn(err, sc[c]);",
          "e[c] = __fdividef(err, sc[c]);"),
         ("float r = __fsqrt_rn(", "float r = sqrtf(")], None, False),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sha(tensors) -> str:
    digest = hashlib.sha256()
    for x in tensors:
        digest.update(x.contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


SPIN_S = 0.5   # seconds of launches before each timing


def _spin(call) -> None:
    """Launch ``call`` back to back for SPIN_S seconds: the card's clocks
    up before the timing."""
    import time

    stop = time.perf_counter() + SPIN_S
    while time.perf_counter() < stop:
        call()
        torch.cuda.synchronize()


def _sm_clock(call, seconds: float = 1.0) -> list:
    """The SM clock (MHz) nvidia-smi reads while ``call`` runs back to back
    for about ``seconds``."""
    import threading
    import time

    stop = time.perf_counter() + seconds

    def busy():
        while time.perf_counter() < stop:
            call()
        torch.cuda.synchronize()

    th = threading.Thread(target=busy)
    th.start()
    got = []
    while th.is_alive():
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True, timeout=30)
        got.append(int(res.stdout.split()[0]))
    th.join()
    return got


def run(variant: str, reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_hh_trip_torch: no CUDA device")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_d0_torch as T
    from ionflux_torch.models.registry import HH_B06
    from ionflux_torch.ops import _build
    from ionflux_torch.ops import hh_solve as H

    subs, group, rk4 = VARIANTS[variant]
    with open(_build.SOURCES["hh_solve"]) as fh:
        src = fh.read()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{variant}: the source no longer holds {old!r}"
                             f" once")
        src = src.replace(old, new)
    if subs:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        path = os.path.join(_build.BUILD_DIR, f"hh_solve_{variant}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        _build.SOURCES["hh_solve"] = path
    regs, kernel = {}, ""
    for line in _build.load_library("hh_solve").build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "hh_trip_kernel" in kernel and ("registers" in line
                                             or "spill" in line):
            name = "G=" + kernel.split("hh_trip_kernelILi")[1].split("E")[0]
            regs.setdefault(name, []).append(line.strip())

    C = _chip_smoke()
    dev = torch.device("cuda", 0)
    protos3, _, _, period3 = T._sweep_protos(T.RECORDINGS[0], dev)
    dt = float(protos3.dt[0])
    v3 = protos3.v[0]
    base = np.array([float(x) for x in HH_B06])
    pop128 = torch.tensor(
        base[None] * np.exp(0.1 * np.random.RandomState(0).randn(128, 8)),
        dtype=torch.float32, device=dev)
    kw = dict(proto_t0=0.0, proto_dt=dt, t_end=period3 * dt, rtol=1e-5,
              atol=1e-7, trips=C.HH_TRIPS)
    out = {}
    lanes = (128, 8) + ((32, 33, 64) if variant == "cycles" else ())
    for name, params in ((f"B3 {b} lanes", pop128[:b].contiguous())
                         for b in lanes):
        b = params.shape[0]
        g = group or H.hh_trip_geometry(b)["group"]
        if -(-b // 32) * 32 + -(-b * g // 32) * 32 > H.MAX_THREADS:
            continue            # more threads than the block takes
        call = lambda p=params: H._hh_pop_solve(p, v3, None, plain=False,
                                                **kw)
        _spin(call)
        ms, res = C.cuda_ms(call, reps)
        n_valid = int(res[3][1])
        out[name] = {"layout": H.fused_hh_pop_solve_ft.last_layout,
                     "ms_per_trip": ms / n_valid,
                     "n_valid": n_valid, "n_acc": int(res[3][0]),
                     "records_sha256": _sha([r[:n_valid] for r in res[:3]]
                                            + [res[3], res[4]])}
        if variant == "cycles":
            cyc = res[0].reshape(-1)[-5:].tolist()
            out[name]["cycles_per_trip"] = dict(zip(
                CYCLE_PHASES, (c / n_valid for c in cyc)))
            out[name]["sm_clock_mhz"] = _sm_clock(call)
    if rk4:
        n_out = period3 // 10 + 1
        substeps = (n_out - 1) * 10
        ms, ys = C.cuda_ms(lambda: H.fused_hh_rk4(
            pop128, v3, proto_dt=dt, dt_out=1.0, n_out=n_out, n_sub=10),
            reps)
        out["B5 128 lanes"] = {
            "layout": H.fused_hh_rk4.last_layout,
            "us_per_substep": ms * 1e3 / substeps, "ms": ms,
            "trace_sha256": _sha([ys])}
    line = {"variant": variant, "card": C.device_line(), "launches": out,
            "ptxas": regs}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS),
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--reps", type=int, default=20)
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
