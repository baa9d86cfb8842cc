"""The HBM bandwidth B1's weight stream achieves in the traced validation
call, as a share of the card's 3.35 TB/s: each segment's executed trips
(``b1.trips_executed``) x the 6 right-hand sides a trip x the packed member
weights a right-hand side reads (``b1.stream_bytes``, the program's own
count of its launch plan), over the device time of B1's kernel
(``trip_kernel``) in the trace (benchmark/hbm.py).  None where the program
counts no stream bytes or the stream fits the L2."""

from benchmark import hbm
from benchmark import spans as S

DRIVERS = ("validate",)
UNIT = "%"
KERNEL = "trip_kernel"


def read(tr):
    found = S.traced(tr, "rollout")
    ms = sum(d for name, _, d in tr["ops"] if KERNEL in name) / 1e3
    if found is None or ms <= 0.0:
        return None
    spans, counts = found
    ids = {s.id for s in spans}
    by_name = {"b1.trips_executed": {}, "b1.stream_bytes": {}}
    for c in counts:
        if c.root in ids and c.name in by_name:
            by_name[c.name][(c.root, c.attrs.get("segment"))] = c.value
    run, nbytes = by_name["b1.trips_executed"], by_name["b1.stream_bytes"]
    segments = [(run[k], nbytes[k]) for k in run if k in nbytes]
    stream = hbm.b1_stream_ms(segments) if segments else None
    return None if stream is None else 100.0 * stream / ms
