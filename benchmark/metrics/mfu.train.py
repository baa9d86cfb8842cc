"""The Adam update's share of the card's float32 peak (fit/train.py::
_UpdateGraph): the MLP's forward and backward on every surface point
(benchmark/flops.py) over the host seconds of an update
(benchmark/harness.py::peak_share)."""

from benchmark.harness import peak_share as read  # noqa: F401

DRIVERS = ("surface_train",)
UNIT = "%"
