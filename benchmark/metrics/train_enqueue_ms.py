"""Host milliseconds of the untraced surface-training call's ``fit_chunk``
span (fit/train.py: loading the update graph's static copies, queueing its
replays, the snapshot): how long the host takes to enqueue a chunk the card
then runs (benchmark/spans.py)."""

from benchmark import spans as S

DRIVERS = ("surface_train",)
UNIT = "ms"


def read(tr):
    return S.untraced_ms(tr, "fit_chunk")
