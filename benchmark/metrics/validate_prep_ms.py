"""Device idle milliseconds a validation call spends in its host
preparation (``eval.py::population_rollout_maes``' ``rollout.prepare``
span: the segmentation, the target and weight arrays, the uploads and the
copies into the graph's inputs): the trace's idle gaps inside that span of
the traced call, per call (benchmark/spans.py)."""

from benchmark import spans as S

DRIVERS = ("validate",)
UNIT = "ms"


def read(tr):
    found = S.traced(tr, "rollout.prepare")
    if found is None or not found[0] or tr["calls"] < 1:
        return None
    idle_us = 0.0
    for s in found[0]:
        lo, hi = s.start_ns / 1e3, s.end_ns / 1e3
        idle_us += sum(max(0.0, min(e, hi) - max(b, lo))
                       for b, e in tr["gaps"])
    return idle_us / 1e3 / tr["calls"]
