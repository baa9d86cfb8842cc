"""The whole validation call's share of the card's float32 peak: B1's
operations for the accepted steps of these inputs (benchmark/flops.py)
over the host seconds of a call (benchmark/harness.py::peak_share)."""

from benchmark.harness import peak_share as read  # noqa: F401

DRIVERS = ("validate",)
UNIT = "%"
