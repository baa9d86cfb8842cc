#!/usr/bin/env python3
"""Run one cell of the benchmark of ionflux_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell is benchmark/workloads/<name>.json: its configuration
(benchmark/configs/), its traffic mix (benchmark/traffic/, parameters read
by the driver the mix names, benchmark/drivers/) and its end-to-end metric.
Set-up (inputs and weights from the seed, every shape the cell uses warmed
and captured) is timed as ``setup_s``; then a closed loop of calls runs for
``--seconds``.  With ``--trace 1`` the same number of calls runs untimed
and then under the profiler, and the per-layer readers
(benchmark/metrics/) take their metrics from the trace.  After the window
the program's state is freed and the driver compares what the timed path
produced with the plain reference (benchmark/reference/); every number
compared is printed beside its limit, and the last line of standard output
is the result as one JSON object.  Exits 1 without a result where there is
no CUDA card, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness as H  # noqa: E402

F32_PEAK = 67e12


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def traced(torch, cell, run_call, calls: int) -> tuple[dict, H.Window]:
    """``calls`` calls without the profiler (their host seconds are the
    peak shares' base), then the same number under it (the idle share and
    the device metrics are read from these alone)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = cell.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    plain = H.Window(0).run(run_call, max_calls=calls)
    with profile(activities=acts) as prof:
        win = H.Window(0).run(run_call, max_calls=calls)
        if cuda:
            torch.cuda.synchronize()
    t = time.perf_counter()
    tr = H.device_trace(prof)
    cell.log(f"trace read in {time.perf_counter() - t:.1f} s: "
             f"{len(tr['ops'])} device operations")
    tr.update(window_s=win.elapsed, plain_s=plain.elapsed, calls=win.calls,
              units=win.units, attempted=win.attempted, peak=F32_PEAK)
    return tr, win


def main(argv=None, *, mix: dict | None = None, device: str | None = None
         ) -> dict:
    """One run; returns the result (also printed).  ``mix`` and ``device``
    replace the cell's traffic mix and the card for the CPU tests."""
    args = parse(argv)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            sys.exit(1)
        device = "cuda:0"
    dev = torch.device(device)
    cell = H.Cell.find(args.workload, args.seed, mix)
    cell.device = dev
    chips = int(cell.workload.get("chips", 1))
    if dev.type == "cuda" and torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = cell.driver()

    t0 = time.perf_counter()
    run = driver.setup(cell)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cell.log(f"set-up {setup_s:.3f} s")

    metrics, breakdown, extra = {}, None, {}
    if args.trace:
        tr, win = traced(torch, cell, run.call,
                         int(cell.mix.get("trace_calls", 1)))
        tr.update(info=run.trace_info(), workload=cell.name,
                  driver=cell.mix["driver"])
        for name, reader in H.readers().items():
            if cell.mix["driver"] not in reader.DRIVERS:
                continue
            value = reader.read(tr)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
        breakdown = H.breakdown(tr)
        extra = {"busy_s": tr["busy_us"] / 1e6, "window_s": tr["window_s"]}
    else:
        win = H.Window(args.seconds).run(run.call)
        metrics[cell.workload["metric"]] = {
            "value": win.units / win.elapsed,
            "unit": cell.workload["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        cell.log(f"window {win.elapsed:.3f} s, {win.calls} calls, "
                 f"{win.units} {cell.workload['unit'].split('/')[0]}, call s "
                 f"{[round(x, 4) for x in win.call_s[:40]]}")
    info = device_info(torch, dev)
    info.update(extra)

    found = H.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        sys.exit(3)

    t = time.perf_counter()
    checks = run.check()
    cell.log(f"reference comparison {time.perf_counter() - t:.1f} s")
    found = H.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        sys.exit(3)
    correct = bool(checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    compared = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    for n, v, lim in checks:
        print(f"{n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
