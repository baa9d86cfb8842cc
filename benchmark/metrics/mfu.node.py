"""The neural-ODE update's share of the card's float32 peak
(solver/fixed.py::_interval and the trainer's two graphs): each RK4
right-hand side's MLP forward and backward (benchmark/flops.py) over the
host seconds of an update (benchmark/harness.py::peak_share)."""

from benchmark.harness import peak_share as read  # noqa: F401

DRIVERS = ("node_train",)
UNIT = "%"
