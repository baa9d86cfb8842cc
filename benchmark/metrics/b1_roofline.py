"""B1's share of its roofline in a validation call: the least time the
card needs for the accepted steps of these inputs (6 right-hand sides a
step on every requested lane, the inputs read and the records written
once; benchmark/flops.py) over the device time of B1's kernel
(``trip_kernel``, ops/fused_solve.py -> csrc/fused_solve.cu) in the trace.
The accepted steps are the traced calls' own counts (``b1.trips_accepted``
of each segment's launch, in the ``rollout`` span; benchmark/spans.py)."""

from benchmark import spans as S

DRIVERS = ("validate",)
UNIT = "%"
KERNEL = "trip_kernel"


def read(tr):
    ms = sum(d for name, _, d in tr["ops"] if KERNEL in name) / 1e3
    work = S.b1_work(tr)
    if ms <= 0.0 or work is None:
        return None
    return 100.0 * work["b1_bound_ms"] / ms
