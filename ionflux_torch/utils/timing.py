"""Per-stage wall time and solve throughput (counterpart of
``ionflux/utils/timing.py``).

The clocks end in a synchronise of the card: CUDA launches return before
the device has run them, so a host clock without one measures the enqueue.
``sync`` names what to wait for: a tensor (or a tuple or list of them) or a
device; a CUDA one synchronises that device, a CPU one needs nothing.
``torch.profiler`` can wrap any stage for a full trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _sync(x) -> None:
    """Wait for the device work behind x: a tensor, a device, or a tuple,
    list or dict of them."""
    if isinstance(x, (tuple, list)):
        for v in x:
            _sync(v)
        return
    if isinstance(x, dict):
        _sync(list(x.values()))
        return
    if isinstance(x, torch.Tensor):
        x = x.device
    elif isinstance(x, str):
        x = torch.device(x)
    if isinstance(x, torch.device) and x.type == "cuda":
        torch.cuda.synchronize(x)


class StageTimer:
    """Accumulates wall time per named stage, synchronised with the
    device of ``sync``."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        _sync(sync)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{name:>24s}: {tot:8.3f}s over {self.counts[name]} calls"
                 for name, tot in sorted(self.totals.items(),
                                         key=lambda kv: -kv[1])]
        return "\n".join(lines)


def solves_per_sec(fn, *args, n_solves: int, reps: int = 5,
                   warmup: int = 1) -> float:
    """Steady-state whole-solve throughput of fn(*args), each call
    ``n_solves`` solves; the clock waits for the device of fn's output."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return n_solves * reps / (time.perf_counter() - t0)
