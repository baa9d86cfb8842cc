"""The float64 reference of the neural-ODE trainer's fused update and the
gap measure it is held to, shared by ``tests/test_torch_node_rk4.py``'s
card test and ``chip_smoke.py``'s phase (u).

Importable without JAX.  The reference runs ``ops/node_rk4.py``'s plain
versions (``forward_plain``, ``vjp_plain``) and torch's Adam in float64,
on the trainer's loss, protocol, outputs and start.
"""

import os
import sys

import numpy as np
import torch

from ionflux_torch import protocols as TP
from ionflux_torch.models.registry import HH_B06
from ionflux_torch.ops import node_rk4 as NR

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import train_neural_ode_torch as NO  # noqa: E402

# The fused update against the float64 reference and against the eager
# update (float32): each loss relative, the first gradient and the net's
# change by leaf (``norm_gap``).  Readings (card test, published net, seed
# 4, 301 outputs): the fused update against float64 4.1e-6 (losses),
# 4.2e-6 (first gradient), 6.4e-5 (the net's change after 3 updates); the
# eager update against float64 2.2e-5, 6.8e-5, 5.5e-3, so the gap between
# the two is the eager update's own float32 rounding (2.1e-5, 6.7e-5,
# 5.5e-3).  The bfloat16 control (PERF.md section 2) reads 2.4e-2, 2.1e-2,
# 1.3e-2 and up against float64.  Each limit sits ~10-25x above its
# reading and below the control; the change against the eager update takes
# the benchmark's change_gap limit, since float32 itself reads within 3x of
# the control there.
F64_LOSS_RTOL, F64_GRAD_TOL, F64_CHANGE_TOL = 1e-4, 1e-4, 1e-3
EAGER_LOSS_RTOL, EAGER_GRAD_TOL, EAGER_CHANGE_TOL = 2e-4, 6e-4, 3e-2


def norm_gap(a, b) -> float:
    """The widest gap over leaves, each against the larger of its
    reference norm (b) and the median leaf's (the benchmark's
    ``norm_gap``)."""
    norms = [float(y.double().norm()) for y in b]
    floor = float(np.median(norms))
    return max(float((x.double() - y.double()).norm()) / max(n, floor)
               for x, y, n in zip(a, b, norms))


def f64_reference(trainer, leaves, updates: int):
    """(losses, first gradient, change after ``updates``, first ys) of
    ``updates`` Adam updates from ``leaves`` by the plain versions in
    float64: the trainer's loss, protocol, outputs and start, torch's Adam
    at the trainer's rate."""
    proto = TP.Protocol(*(x.double() for x in trainer.proto))
    ts, y0 = trainer.ts.double(), trainer.y0.double()
    l64 = [x.detach().double().clone().requires_grad_(True) for x in leaves]
    opt = torch.optim.Adam(l64, lr=NO.LR, eps=1e-8)
    losses, first, ys_first = [], None, None
    for _ in range(updates):
        layers = list(zip(l64[0::2], l64[1::2]))
        with torch.no_grad():
            ys, starts = NR.forward_plain(layers, proto, ts, y0, NO.RK4_SUB,
                                          HH_B06)
        ys_first = ys if ys_first is None else ys_first
        ys.requires_grad_(True)
        loss = trainer._loss_of(ys)
        (g_ys,) = torch.autograd.grad(loss, ys)
        with torch.no_grad():
            grads = NR.vjp_plain(layers, proto, ts, starts, g_ys, NO.RK4_SUB,
                                 HH_B06)
        first = first or [g.clone() for g in grads]
        losses.append(float(loss.detach()))
        for p, g in zip(l64, grads):
            p.grad = g
        opt.step()
    return losses, first, [p.detach() - x.double()
                           for p, x in zip(l64, leaves)], ys_first.detach()


def gaps(run, ref, leaves) -> tuple[float, float, float]:
    """(loss, first gradient, change) gaps of a run (losses, first
    gradient, the net's leaves now) against a reference (losses, first
    gradient, change, as ``f64_reference`` begins): the widest relative
    loss gap and ``norm_gap``s."""
    losses, first, flat = run
    r_losses, r_first, r_change = ref[:3]
    change = [p.detach() - x for p, x in zip(flat, leaves)]
    return (max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            norm_gap(first, r_first), norm_gap(change, r_change))
