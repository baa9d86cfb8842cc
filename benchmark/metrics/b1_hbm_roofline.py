"""B1's share of its byte roofline where the members outgrow the L2: the
least HBM time the traced call's accepted steps need (their own
``b1.trips_accepted`` counts by segment; 6 right-hand sides a step, each
reading every member's weights but the L2's worth, and the knots once;
benchmark/hbm.py) over the device time of B1's kernel (``trip_kernel``,
ops/fused_solve.py -> csrc/fused_solve.cu) in the trace.  None where the
members fit the L2."""

from benchmark import hbm
from benchmark import spans as S

DRIVERS = ("validate",)
UNIT = "%"
KERNEL = "trip_kernel"


def read(tr):
    ms = sum(d for name, _, d in tr["ops"] if KERNEL in name) / 1e3
    accepted = S.traced_counts(tr, "rollout", "b1.trips_accepted")
    if ms <= 0.0 or not accepted:
        return None
    info = tr["info"]
    bound = hbm.b1_hbm_bound_ms(accepted, info["sizes"], info["members"],
                                info["knots"])
    return None if bound is None else 100.0 * bound / ms
