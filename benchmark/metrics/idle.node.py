"""The device's idle share in neural-ODE training calls, from the traced run
(benchmark/harness.py::idle_share)."""

from benchmark.harness import idle_share as read  # noqa: F401

DRIVERS = ("node_train",)
UNIT = "%"
