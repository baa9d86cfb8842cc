"""The program's own spans and counts (``ionflux_torch/utils/timing.py``) as
the per-layer readers take them.

The traced calls are whatever lies between the first and the last host
event of the profiler's trace (``tr["host"]``, whose stamps share the
recorder's clock); the untraced calls are the last ``tr["calls"]`` spans of
a name that end before that window (``run.py::traced`` runs as many calls
unprofiled just before).  A program that records nothing, or has no
recorder, gives every reader nothing to read: it returns None and never
raises."""

from __future__ import annotations

import importlib

from benchmark import flops


def recorded():
    """(spans, counts) that the program's recorder holds, or None where the
    program has none."""
    try:
        timing = importlib.import_module("ionflux_torch.utils.timing")
    except ImportError:
        return None
    if not (hasattr(timing, "spans") and hasattr(timing, "counts")):
        return None
    return timing.spans(), timing.counts()


def window(tr):
    """(first, last) ns of the traced calls' host events, or None."""
    if not tr.get("host"):
        return None
    return (min(s for _, s, _ in tr["host"]) * 1e3,
            max(e for _, _, e in tr["host"]) * 1e3)


def traced(tr, name: str):
    """(spans named ``name`` that overlap the traced calls, every count),
    or None where there is no window or no recorder."""
    rec, win = recorded(), window(tr)
    if rec is None or win is None:
        return None
    spans, counts = rec
    lo, hi = win
    return ([s for s in spans if s.name == name and s.end_ns > lo
             and s.start_ns < hi], counts)


def traced_counts(tr, root: str, name: str) -> list:
    """Values of the counts ``name`` made inside the traced calls' spans
    named ``root`` (their top-level spans)."""
    found = traced(tr, root)
    if found is None:
        return []
    spans, counts = found
    ids = {s.id for s in spans}
    return [c.value for c in counts if c.name == name and c.root in ids]


def b1_work(tr):
    """B1's operations and bound (``flops.b1_work``) over the segments of
    the traced calls, from the accepted trips the graph path counted for
    each (``b1.trips_accepted`` in the ``rollout`` span) and the shapes
    drivers/validate.py's ``trace_info`` gives (``tr["info"]``: sizes, kind,
    members, lanes, knots); None where nothing was counted."""
    accepted = traced_counts(tr, "rollout", "b1.trips_accepted")
    if not accepted:
        return None
    info = tr["info"]
    return flops.b1_work(accepted, info["lanes"], info["sizes"],
                         info["kind"], knots_per_segment=info["knots"],
                         members=info["members"])


def untraced_ms(tr, name: str):
    """Mean host ms of the untraced calls' spans named ``name``, or None."""
    rec, win = recorded(), window(tr)
    if rec is None or win is None or tr.get("calls", 0) < 1:
        return None
    before = sorted((s for s in rec[0] if s.name == name
                     and s.end_ns <= win[0]), key=lambda s: s.end_ns)
    last = before[-int(tr["calls"]):]
    if not last:
        return None
    return sum(s.end_ns - s.start_ns for s in last) / len(last) / 1e6
