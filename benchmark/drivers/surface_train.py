"""Surface training: ``fit.train.fit_chunk``, full-batch Adam on the
(V / 100, a) -> da/dt surface in chunks of the study's ``val_every``
updates (one CUDA graph replay an update), the loop of every synthetic
study.

Set-up makes the surface and the initial net on the device from the seed,
builds the training state and drives it through the window's own call,
``fit_chunk``: the start, a chunk of 1 update and one of 2 from the seed's
net (on the card the update graph's eager warm-up), which the reference
follows from the same net; then the capture and its replays up to two
updates short of a ``step_size`` boundary; then a chunk of three replayed
updates across the boundary (the staircase rate falls in the third), which
the reference follows from a copy of the state before it (the net, Adam's
moments and the update count).  The window's chunks continue from there.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, gen
from benchmark.reference import models as RM
from benchmark.reference import train as RT

COMPARED_STEPS = 3


def surface(cell):
    """x [N, 2] = (V / 100, a), the target y [N] and NN-d's residual [N]
    (the analytic a-gate of the configuration's base), float32: V drawn
    from the mix's voltage levels, a uniform in (0, 1), the target the
    analytic rate of the mix's ground-truth a-gate plus sigma N(0, 1)."""
    mix, dev = cell.mix, cell.device
    n = int(mix["points"])
    gen_ = gen.generator(cell.seed, dev, stream=5)
    levels = torch.tensor(mix["levels_mv"], dtype=torch.float32, device=dev)
    v = levels[torch.randint(len(levels), (n,), generator=gen_, device=dev)]
    u = torch.rand((2, n), generator=gen_, device=dev, dtype=torch.float32)
    a = u[0].clamp(1e-6, 1 - 1e-6)
    # rand draws from [0, 1): an exact 0 would make the noise -inf, so it
    # is raised to 2^-25 (every other draw is left as it is)
    z = torch.erfinv(2 * u[1].clamp_min(2.0 ** -25) - 1) * 2 ** 0.5
    y = RM.a_rate(mix["truth_gate"], a, v) + float(mix["target_sigma"]) * z
    x = torch.stack([v / 100.0, a], dim=-1)
    residual = (RM.a_rate(cell.config["base_gate"], a, v)
                if cell.config["kind"] == "nnd" else None)
    return x, y, residual


def norm_gap(got, ref) -> float:
    """The widest gap of a leaf's norm from the reference's, over the larger
    of that leaf's reference norm and the median leaf's; leaves whose
    reference norm is under a thousandth of the median leaf's are left
    out (rounding alone moves them)."""
    gn = np.array([float(x.double().norm()) for x in got])
    rn = np.array([float(x.double().norm()) for x in ref])
    med = float(np.median(rn))
    keep = rn >= 1e-3 * med
    if not np.isfinite(gn).all():
        return float("inf")
    return float(np.max(np.abs(gn - rn)[keep]
                        / np.maximum(rn[keep], med)))


def loss_gap(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - ref) / np.abs(ref)))




def _leaves(pairs) -> list:
    return [t for pair in pairs for t in pair]


START = ("loss_gap", "grad_gap", "change_gap")
REPLAY = ("replay_loss_gap", "replay_moment_gap", "replay_change_gap")


class Run:
    def __init__(self, cell):
        from ionflux_torch.fit import train as T
        from ionflux_torch.models.nn import MLP

        self.cell, self.T = cell, T
        mix = cell.mix
        self.x, self.y, self.residual = surface(cell)
        self.init = gen.mlp_weights(cell.config["sizes"],
                                    float(mix["init_std"]), cell.seed,
                                    cell.device)
        self.kw = dict(lr=float(mix["lr"]), step_size=int(mix["step_size"]),
                       gamma=float(mix["gamma"]))
        self.chunk = int(mix["chunk"])
        net = MLP([(w.clone(), b.clone()) for w, b in self.init])
        state = T.init_opt_state(net, **self.kw)
        # the start
        net, state, l1 = self._chunk(net, state, 1)
        first_grad = [m.clone() / (1 - RT.BETA1) for m in _leaves(state.mu)]
        net, state, l23 = self._chunk(net, state, COMPARED_STEPS - 1)
        self.start = (torch.cat([l1, l23]).double().cpu().numpy(),
                      first_grad,
                      [a - b for a, b in zip(_leaves(net.layers),
                                             _leaves(self.init))])
        # the capture, and replays up to the compared chunk
        step = self.kw["step_size"]
        net, state, _ = self._chunk(net, state, 1 + (
            step - COMPARED_STEPS - state.count) % step)
        self.snapshot = ([t.clone() for t in _leaves(net.layers)],
                         [t.clone() for t in _leaves(state.mu)],
                         [t.clone() for t in _leaves(state.nu)],
                         int(state.count))
        net, state, losses = self._chunk(net, state, COMPARED_STEPS)
        self.replayed = (losses.double().cpu().numpy(),
                         [t.clone() for t in _leaves(state.mu)],
                         [a - b for a, b in zip(_leaves(net.layers),
                                                self.snapshot[0])])
        self.net, self.state = net, state

    def _chunk(self, net, state, iters: int):
        return self.T.fit_chunk(net, state, self.x, self.y, self.residual,
                                None, iters=iters, **self.kw)

    def call(self):
        self.net, self.state, losses = self._chunk(self.net, self.state,
                                                   self.chunk)
        bad = int((~torch.isfinite(losses)).sum())
        return self.chunk, self.chunk, bad

    def trace_info(self) -> dict:
        ops = flops.surface_update_ops(self.cell.config["sizes"],
                                       int(self.x.shape[0]))
        return {"call_ops": ops * self.chunk}

    def release(self) -> None:
        self.net = self.state = None
        self.T._UpdateGraph._cache.clear()

    def references(self, **kw):
        """The reference's start and replayed chunk (see reference)."""
        leaves, mu, nu, count = self.snapshot
        return (reference(self.cell, _leaves(self.init), self.x, self.y,
                          self.residual, self.kw, **kw),
                reference(self.cell, leaves, self.x, self.y, self.residual,
                          self.kw, state=(mu, nu, count), **kw))

    def check(self):
        lim = self.cell.workload["limits"]
        self.release()
        start, replayed = self.references()
        return (compare(self.start, start, lim, START)
                + compare(self.replayed, replayed, lim, REPLAY))


def reference(cell, leaves, x, y, residual, kw, *, state=None,
              dtype=torch.float64, tf32=False) -> dict:
    """The plain reference's COMPARED_STEPS updates in ``dtype`` from
    ``leaves`` (and Adam's ``state``, (first moments, second moments,
    count), where given): each update's loss, the first gradient, the
    first moments after the last update and the leaves' change."""
    xs, ys = x.to(dtype), y.to(dtype)
    rs = None if residual is None else residual.to(dtype)
    lr, step, gamma = kw["lr"], kw["step_size"], kw["gamma"]
    losses, first, last, moments = RT.first_steps(
        lambda ls: RT.surface_loss(ls, xs, ys, rs), leaves,
        lambda k: lr * gamma ** (k // step), COMPARED_STEPS, dtype=dtype,
        tf32=tf32, state=state)
    return dict(losses=losses, grad=first, moments=moments,
                change=[a - b.to(dtype) for a, b in zip(last, leaves)])


def compare(got, ref, lim, names):
    """(name, value, limit) of the loss, the second (the first gradient at
    the start, the first moments after the replayed chunk) and the change,
    each against the reference."""
    losses, second, change = got
    ref2 = ref["grad"] if names is START else ref["moments"]
    values = (loss_gap(losses, ref["losses"]), norm_gap(second, ref2),
              norm_gap(change, ref["change"]))
    return [(n, v, float(lim[n])) for n, v in zip(names, values)]


def setup(cell) -> Run:
    return Run(cell)


def control(cell, seeds) -> dict:
    """The control's readings on each seed: the reference in float32 with
    TF32 products put in the program's place, judged against the float64
    reference; beside it the same in full float32, which the limits have to
    pass.  The replayed chunk starts from the program's state (a set-up is
    run for it)."""
    out = {}
    for seed in seeds:
        cell.seed = seed
        run = Run(cell)
        run.release()
        lim = cell.workload["limits"]
        ref = run.references()
        out[seed] = {}
        for name, tf32 in (("tf32", True), ("f32", False)):
            low = run.references(dtype=torch.float32, tf32=tf32)
            out[seed][name] = {
                n: v for n, v, _ in
                compare((np.asarray(low[0]["losses"]), low[0]["grad"],
                         low[0]["change"]), ref[0], lim, START)
                + compare((np.asarray(low[1]["losses"]), low[1]["moments"],
                           low[1]["change"]), ref[1], lim, REPLAY)}
    return out
