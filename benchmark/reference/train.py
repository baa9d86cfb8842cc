"""The reference of the two training paths: full-batch Adam on the
derivative surface, and Adam on a current trace through a fixed-step RK4
solve.  Adam is written out here (Kingma & Ba, with PyTorch's eps placement:
theta -= lr m_hat / (sqrt(v_hat) + eps)); gradients come from autograd."""

from __future__ import annotations

import torch

from .models import OUT_SCALE, V_SCALE, current, interp, mlp, net_rate
from .ode import rk4, rk4_stage_times
from .validate import matmul_precision

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam over a list of leaves; ``rate(k)`` is update k's step size.
    ``state`` (first moments, second moments, updates made) continues an
    optimiser part way through; by default it starts from zero."""

    def __init__(self, leaves, rate, state=None):
        self.leaves = [x.detach().clone() for x in leaves]
        if state is None:
            self.m = [torch.zeros_like(x) for x in leaves]
            self.v = [torch.zeros_like(x) for x in leaves]
            self.k = 0
        else:
            m, v, k = state
            self.m = [x.detach().to(leaves[0].dtype).clone() for x in m]
            self.v = [x.detach().to(leaves[0].dtype).clone() for x in v]
            self.k = int(k)
        self.rate = rate

    def step(self, grads) -> None:
        self.k += 1
        lr = self.rate(self.k - 1)
        c1, c2 = 1 - BETA1 ** self.k, 1 - BETA2 ** self.k
        for i, g in enumerate(grads):
            self.m[i] = BETA1 * self.m[i] + (1 - BETA1) * g
            self.v[i] = BETA2 * self.v[i] + (1 - BETA2) * g * g
            self.leaves[i] = self.leaves[i] - lr * (self.m[i] / c1) / (
                torch.sqrt(self.v[i] / c2) + EPS)


def _pairs(leaves):
    return list(zip(leaves[0::2], leaves[1::2]))


def surface_loss(leaves, x, y, residual):
    """sum((MLP(x) / 1000 + residual - y)^2)."""
    pred = net_rate(_pairs(leaves), x[:, 0] * 100.0, x[:, 1])
    if residual is not None:
        pred = pred + residual
    return torch.sum((pred - y) ** 2)


def node_loss(leaves, p, knots, knot_dt, ts, y0, data, n_sub, g, e,
              products=None):
    """mean((I - data)^2) of NN-f through RK4 (n_sub steps an output
    interval) on the linearly interpolated knot voltages (the MLP's
    products rounded to ``products`` where given).  The voltage and
    the r-gate's rates at every stage time are worked out before the solve
    (they do not depend on the state)."""
    layers = _pairs(leaves)
    dt = y0.dtype
    v = interp(knots, knot_dt, rk4_stage_times(ts, n_sub)).to(dt)
    k3 = p[4] * torch.exp(p[5] * v)
    k4 = p[6] * torch.exp(-p[7] * v)
    kk = k3 + k4
    vn = v / V_SCALE

    def rhs(j, y):
        a, r = y[0:1], y[1:2]
        x = torch.cat([vn[j:j + 1], a])[None]
        da = mlp(layers, x, products)[0] / OUT_SCALE
        return torch.cat([da, k4[j:j + 1] - kk[j:j + 1] * r])

    ys = rk4(rhs, y0, ts, n_sub)
    v_t = interp(knots, knot_dt, ts).to(dt)
    return torch.mean((current(ys, v_t, g, e) - data) ** 2)


def first_steps(loss_fn, leaves, rate, steps: int, *, dtype=torch.float64,
                tf32: bool = False, state=None):
    """Adam's first ``steps`` updates of ``loss_fn(leaves)`` from leaves in
    ``dtype`` (from the optimiser ``state`` where given, see Adam): (each
    update's loss before it, the first gradient by leaf, the leaves after
    the last update, the first moments after it)."""
    opt = Adam([x.to(dtype) for x in leaves], rate, state)
    losses, first = [], None
    with matmul_precision(tf32):
        for _ in range(steps):
            cur = [x.clone().requires_grad_(True) for x in opt.leaves]
            loss = loss_fn(cur)
            grads = torch.autograd.grad(loss, cur)
            if first is None:
                first = [gr.detach() for gr in grads]
            losses.append(float(loss.detach()))
            opt.step([gr.detach() for gr in grads])
    return losses, first, opt.leaves, opt.m
