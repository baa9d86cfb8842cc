"""Device microseconds of one B1 trip in the traced validation call: the
device time of B1's kernel (``trip_kernel``) in the trace over the trips
the graph path counted executed (``b1.trips_executed`` in the ``rollout``
span; benchmark/spans.py)."""

from benchmark import spans as S

DRIVERS = ("validate",)
UNIT = "us"
KERNEL = "trip_kernel"


def read(tr):
    run = sum(S.traced_counts(tr, "rollout", "b1.trips_executed"))
    us = sum(d for name, _, d in tr["ops"] if KERNEL in name)
    if run <= 0 or us <= 0.0:
        return None
    return us / run
