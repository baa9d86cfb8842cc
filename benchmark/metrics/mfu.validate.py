"""The whole validation call's share of the card's float32 peak: B1's
operations for the accepted steps of the traced calls (their own
``b1.trips_accepted`` counts; benchmark/spans.py, benchmark/flops.py) over
the host seconds of as many calls timed without the profiler, times the
peak."""

from benchmark import spans as S

DRIVERS = ("validate",)
UNIT = "%"


def read(tr):
    work = S.b1_work(tr)
    if work is None or not work["b1_ops"] or tr["plain_s"] <= 0.0:
        return None
    return 100.0 * work["b1_ops"] / (tr["plain_s"] * tr["peak"])
