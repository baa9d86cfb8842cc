"""What every cell of the benchmark shares: the catalogue of configurations,
traffic mixes, drivers and per-layer readers (each found by name), the
device checks, the closed-loop window, the profiler's reduction and the
result line.  Nothing here imports the program; the drivers do."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that may not be loaded in a run (compared whole:
# the port's own name, ionflux_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ionflux")


def load_json(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json."""
    path = os.path.join(BENCH, kind, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers() -> dict:
    """Every per-layer reader under benchmark/metrics/, by metric name."""
    out = {}
    for fn in sorted(os.listdir(os.path.join(BENCH, "metrics"))):
        if fn.endswith(".py") and not fn.startswith("_"):
            out[fn[:-3]] = load_module("metrics", fn[:-3])
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Cell:
    """One workload resolved: its entry, configuration and traffic mix."""

    name: str
    workload: dict
    config: dict
    mix: dict
    seed: int
    device: object = None

    @classmethod
    def find(cls, name: str, seed: int, mix: dict | None = None) -> "Cell":
        w = load_json("workloads", name)
        return cls(name, w, load_json("configs", w["config"]),
                   mix if mix is not None else load_json("traffic",
                                                         w["traffic"]),
                   int(seed))

    def driver(self):
        """The traffic mix's driver, benchmark/drivers/<name>.py, imported
        as a module of the benchmark's package."""
        name = self.mix["driver"]
        if not os.path.exists(os.path.join(BENCH, "drivers", f"{name}.py")):
            raise FileNotFoundError(f"no driver named {name!r}")
        return importlib.import_module(f"benchmark.drivers.{name}")

    def log(self, *args) -> None:
        print(f"[{self.name}]", *args, file=sys.stderr, flush=True)


class Window:
    """A closed loop of calls: the next call starts when the last returns
    (each call ends synchronised).  ``seconds`` is the loop's length; every
    call that started inside it runs to its end and counts, and the elapsed
    time runs to that end, so the rate is all the work over all the
    time."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.calls = self.units = self.attempted = self.failed = 0
        self.elapsed = 0.0
        self.call_s: list[float] = []

    def run(self, call, max_calls: int | None = None) -> "Window":
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            units, attempted, failed = call()
            end = time.perf_counter()
            self.call_s.append(end - t)
            self.calls += 1
            self.units += units
            self.attempted += attempted
            self.failed += failed
            self.elapsed = end - t0
            if self.elapsed >= self.seconds or (
                    max_calls is not None and self.calls >= max_calls):
                return self


def device_trace(prof) -> dict:
    """The device's side of a profiler trace: every device operation
    (kernel, copy, set) as (name, start us, duration us), the busy time
    (union of their intervals), the idle gaps between them, and the host's
    operations for naming the gaps.  Read from the profiler's raw event
    list, not its tree of function events (a neural-ODE update is two
    million kernels)."""
    from torch.autograd import DeviceType

    dev_ops, host_ops = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev_ops.append((e.name(), e.start_ns() / 1e3,
                            e.duration_ns() / 1e3))
        elif kind == DeviceType.CPU:
            host_ops.append((e.name(), e.start_ns() / 1e3,
                             (e.start_ns() + e.duration_ns()) / 1e3))
    dev_ops.sort(key=lambda x: x[1])
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for _, s, d in dev_ops:
        e = s + d
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return dict(ops=dev_ops, busy_us=busy, gaps=gaps, host=host_ops)


def breakdown(tr: dict, top: int = 10) -> dict:
    """The ten device operations that took most time (seconds, summed by
    name) and the ten longest idle gaps, each named by the innermost host
    operation running when it began."""
    by_name: dict[str, float] = {}
    for name, _, d in tr["ops"]:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    gaps = sorted(tr["gaps"], key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        inner, width = "host", None
        for name, hs, he in tr["host"]:
            if hs <= s < he and (width is None or he - hs < width):
                inner, width = name, he - hs
        named.append([f"during {inner}", (e - s) / 1e6])
    return {"device_ops": [[n, d / 1e6] for n, d in ops],
            "idle_gaps": named}


def idle_share(tr: dict):
    """The device's idle share of the traced window, in %: 1 - the busy
    time (the union of every device operation's interval) / the traced
    calls' host seconds, both from the one traced run."""
    if tr["busy_us"] <= 0.0 or tr["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / 1e6 / tr["window_s"])


def peak_share(tr: dict):
    """The calls' share of the card's float32 peak, in %: the operations of
    a call counted from shapes (the driver's ``call_ops``, benchmark/
    flops.py) over the host seconds of a call timed without the profiler,
    times the peak."""
    ops = tr["info"].get("call_ops")
    if not ops or tr["plain_s"] <= 0.0 or tr["calls"] < 1:
        return None
    return 100.0 * ops * tr["calls"] / (tr["plain_s"] * tr["peak"])
