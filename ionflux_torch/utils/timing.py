"""Per-stage wall time and solve throughput (counterpart of
``ionflux/utils/timing.py``).

The clocks end in a synchronise of the card: CUDA launches return before
the device has run them, so a host clock without one measures the enqueue.
``sync`` names what to wait for: a tensor (or a tuple or list of them) or a
device; a CUDA one synchronises that device, a CPU one needs nothing.
``torch.profiler`` can wrap any stage for a full trace.

``span`` and ``count`` are the other clock: an always-on record of the
program's phases and counts that never synchronises the card.  A span is
(id, parent id, root id, name, start ns, end ns, attrs); spans nest by a
per-thread stack, and every span of one call carries its top-level span's
id as ``root``.  A count is (enclosing span id, its root, name, ns, value,
attrs).  Both go into bounded rings (``RING`` entries each; the oldest
fall out) that ``spans()`` and ``counts()`` return.  The stamps are
``time.time_ns()``, the clock of ``torch.profiler``'s host events
(``start_ns()`` of its kineto events), so a span lines up with the kernels
it launched.  Spans cover calls and phases, never single launches: one
costs two clock reads and an append.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

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


RING = 1 << 16      # spans (and counts) the recorder keeps


class Span(NamedTuple):
    id: int
    parent: int | None      # the enclosing span's id; None at the top
    root: int               # the top-level span's id (its own at the top)
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


class Count(NamedTuple):
    span: int | None        # the enclosing span's id
    root: int | None        # its top-level span's id
    name: str
    ns: int
    value: object
    attrs: dict


class Recorder:
    """Spans and counts in two rings of ``maxlen`` entries; thread-safe
    (each thread nests its own spans)."""

    def __init__(self, maxlen: int = RING):
        self._spans: deque = deque(maxlen=maxlen)
        self._counts: deque = deque(maxlen=maxlen)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record the block as a span named ``name``, closed however the
        block ends; yields the span's id."""
        stack = self._stack()
        sid = next(self._ids)
        parent, root = stack[-1] if stack else (None, sid)
        stack.append((sid, root))
        start = time.time_ns()
        try:
            yield sid
        finally:
            end = time.time_ns()
            stack.pop()
            self._spans.append(Span(sid, parent, root, name, start, end,
                                    attrs))

    def count(self, name: str, value, **attrs) -> None:
        """Record ``value`` (a host number) under ``name`` in the
        enclosing span."""
        stack = self._stack()
        sid, root = stack[-1] if stack else (None, None)
        self._counts.append(Count(sid, root, name, time.time_ns(), value,
                                  attrs))

    def spans(self) -> list[Span]:
        return list(self._spans)

    def counts(self) -> list[Count]:
        return list(self._counts)


# The program's recorder: always on
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
spans = RECORDER.spans
counts = RECORDER.counts
