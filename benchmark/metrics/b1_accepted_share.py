"""B1's accepted share of its executed trips in the traced validation call,
read from the graph path's own counts (``eval.py::population_rollout_maes``:
``b1.trips_accepted`` / ``b1.trips_executed`` of each segment's launch, in
the ``rollout`` span; benchmark/spans.py)."""

from benchmark import spans as S

DRIVERS = ("validate",)
UNIT = "%"


def read(tr):
    run = sum(S.traced_counts(tr, "rollout", "b1.trips_executed"))
    accepted = sum(max(v, 0) for v in S.traced_counts(
        tr, "rollout", "b1.trips_accepted"))
    if run <= 0:
        return None
    return 100.0 * accepted / run
