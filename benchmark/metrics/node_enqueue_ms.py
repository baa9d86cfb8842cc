"""Host milliseconds of the untraced neural-ODE call's ``node.step`` span
(scripts/train_neural_ode_torch.py::Trainer.step: 300 forward replays, the
loss, 300 vector-Jacobian replays, Adam): how long the host takes to
enqueue an update the card then runs (benchmark/spans.py)."""

from benchmark import spans as S

DRIVERS = ("node_train",)
UNIT = "ms"


def read(tr):
    return S.untraced_ms(tr, "node.step")
