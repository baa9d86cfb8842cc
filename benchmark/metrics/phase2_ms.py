"""Device milliseconds a validation call spends outside B1's kernel: the
dense output and the MAE reduction of eval.py (``_popsweep_segment_reduce``)
and the copies into the replayed graph, from the trace."""

DRIVERS = ("validate",)
UNIT = "ms"
KERNEL = "trip_kernel"


def read(tr):
    other = [d for name, _, d in tr["ops"] if KERNEL not in name]
    if not other or tr["calls"] < 1:
        return None
    return sum(other) / 1e3 / tr["calls"]
