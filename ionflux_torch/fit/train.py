"""Derivative-surface training (counterpart of ``ionflux/fit/train.py``):
full-batch Adam with a staircase learning-rate decay on the (V/100, a) ->
da/dt surface.

- loss: the sum of squares over the surface (``surface_loss``); NN-d trains
  the MLP on the residual: pred = net(x) / 1000 + the analytic part;
- optimiser: ``torch.optim.Adam`` (eps 1e-8) where the reference chains
  optax's Adam with ``exponential_decay(staircase=True)``: update k (k = 0,
  1, ...) takes the rate lr * gamma^floor(k / step_size), a constant rate
  when step_size is None;
- ``init_opt_state`` / ``fit_chunk``: the optimiser state (update count and
  both moments) passes between chunks, so chunks of 17 + 17 + 16 updates
  give the result of one chunk of 50 bit for bit;
- the pretrain stage and the boundary-anchor grid.

A chunk keeps its losses on the device of x; the host reads nothing inside
a chunk.  On the CPU it runs eagerly.  On a CUDA device one update
(forward, backward, the schedule and a capturable Adam step, the rate a
tensor) is captured as a CUDA graph once per (shapes, settings) and
replayed for every update (``_UpdateGraph``), since the host's launches
left the device idle; the float32 products must not run in TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ionflux_torch._device import resolve_device
from ionflux_torch.models.hh import a_gate_rhs
from ionflux_torch.models.nn import MLP, mlp_apply
from ionflux_torch.models.registry import HHParams, NETSCALE, VRANGE
from ionflux_torch.utils.timing import count, span

ADAM_EPS = 1e-8


class TrainResult(NamedTuple):
    params: MLP             # trained MLP
    losses: torch.Tensor    # [iters] per-iteration loss, on the device


class AdamState(NamedTuple):
    """The optimiser's state between chunks: updates done so far and the
    first and second moments, as (W, b) pairs like the net."""

    count: int
    mu: list
    nu: list


def _layers(net) -> list:
    return net.layers if isinstance(net, MLP) else list(net)


def surface_loss(net, x: torch.Tensor, y: torch.Tensor,
                 residual: torch.Tensor | None = None,
                 anchors=None) -> torch.Tensor:
    """Sum-of-squares loss on the derivative surface.  x: [N, 2] =
    (V/100, a); y: [N] target da/dt; residual: [N] added to the MLP's
    prediction (NN-d's analytic part); anchors: optional (x_a, y_a, weight)
    pulling the raw MLP output towards y_a off the training hull."""
    pred = mlp_apply(net, x)[..., 0] / NETSCALE
    if residual is not None:
        pred = pred + residual
    loss = torch.sum((pred - y) ** 2)
    if anchors is not None:
        x_a, y_a, w = anchors
        pred_a = mlp_apply(net, x_a)[..., 0] / NETSCALE
        loss = loss + w * torch.sum((pred_a - y_a) ** 2)
    return loss


def init_opt_state(net, lr: float = 1e-3, step_size: int | None = 100,
                   gamma: float = 0.9) -> AdamState:
    """A fresh optimiser state for net (no update done, zero moments).  The
    rate settings are fit_chunk's arguments, as in the reference."""
    zeros = [(torch.zeros_like(w), torch.zeros_like(b))
             for w, b in _layers(net)]
    return AdamState(0, zeros, [(w.clone(), b.clone()) for w, b in zeros])


def _rate(lr: float, step_size: int | None, gamma: float, k: int) -> float:
    return lr if step_size is None else lr * gamma ** (k // step_size)


def fit_chunk(net, opt_state: AdamState, x, y, residual=None, anchors=None,
              *, iters: int, lr: float = 1e-3, step_size: int | None = 100,
              gamma: float = 0.9):
    """``iters`` Adam updates from (net, opt_state) -> (net, opt_state,
    losses [iters] on the device).  The inputs are not changed: the
    returned net and state are new tensors.  The call is a ``fit_chunk``
    span (``utils/timing.py``); on the card its phases are spans too
    (``_UpdateGraph.run``), and the counts ``fit_chunk.updates_eager`` and
    ``fit_chunk.updates_replayed`` say how its updates ran."""
    with span("fit_chunk", iters=iters):
        if x.device.type == "cuda":
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("surface training runs in float32: set "
                                   "torch.backends.cuda.matmul.allow_tf32 "
                                   "= False")
            return _UpdateGraph.get(net, x, residual, anchors, lr, step_size,
                                    gamma).run(net, opt_state, x, y,
                                               residual, anchors, iters)
        count("fit_chunk.updates_eager", iters)
        return _fit_chunk_eager(net, opt_state, x, y, residual, anchors,
                                iters, lr, step_size, gamma)


def _fit_chunk_eager(net, opt_state, x, y, residual, anchors, iters, lr,
                     step_size, gamma):
    """fit_chunk off the card: every update eager."""
    flat = [t.detach().clone().requires_grad_(True)
            for pair in _layers(net) for t in pair]
    pairs = list(zip(flat[0::2], flat[1::2]))
    opt = torch.optim.Adam(flat, lr=lr, eps=ADAM_EPS)
    moments = [t for pair in opt_state.mu for t in pair], \
        [t for pair in opt_state.nu for t in pair]
    for p, m, v in zip(flat, *moments):
        opt.state[p] = {"step": torch.tensor(float(opt_state.count)),
                        "exp_avg": m.detach().clone(),
                        "exp_avg_sq": v.detach().clone()}
    losses = []
    for k in range(iters):
        opt.param_groups[0]["lr"] = _rate(lr, step_size, gamma,
                                          opt_state.count + k)
        opt.zero_grad(set_to_none=True)
        loss = surface_loss(pairs, x, y, residual, anchors)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    net, state = _snapshot(flat, opt, opt_state.count + iters)
    return net, state, torch.stack(losses) if losses else x.new_empty(0)


def _snapshot(flat, opt: torch.optim.Adam, count: int):
    """(net, AdamState) of new tensors from an optimiser's parameters."""
    mu = [opt.state[p]["exp_avg"].detach().clone() for p in flat]
    nu = [opt.state[p]["exp_avg_sq"].detach().clone() for p in flat]
    return (MLP([(w.detach().clone(), b.detach().clone())
                 for w, b in zip(flat[0::2], flat[1::2])]),
            AdamState(count, list(zip(mu[0::2], mu[1::2])),
                      list(zip(nu[0::2], nu[1::2]))))


class _UpdateGraph:
    """One Adam update on the card as a CUDA graph over static copies of
    the net, the optimiser state, the surface and the rate.  The rate is
    set inside the graph from the update count (the staircase schedule),
    and Adam is capturable, so a replay is a whole update with no host
    work.  The first WARMUP updates of a setting run eagerly on a side
    stream (the capture's warm-up, real updates all the same); the capture
    follows."""

    _cache: dict = {}
    WARMUP = 3          # eager updates before the capture (lazy set-up)

    @classmethod
    def get(cls, net, x, residual, anchors, lr, step_size, gamma):
        key = (str(x.device), tuple(tuple(t.shape) for pair in _layers(net)
                                    for t in pair), tuple(x.shape),
               residual is None,
               None if anchors is None else tuple(anchors[0].shape),
               float(lr), step_size, float(gamma))
        g = cls._cache.get(key)
        if g is None:
            g = cls._cache[key] = cls(net, x, residual, anchors, lr,
                                      step_size, gamma)
        return g

    def __init__(self, net, x, residual, anchors, lr, step_size, gamma):
        dev = x.device
        self.flat = [t.detach().clone().requires_grad_(True)
                     for pair in _layers(net) for t in pair]
        self.pairs = list(zip(self.flat[0::2], self.flat[1::2]))
        self.x = x.clone()
        self.y = torch.empty(x.shape[0], dtype=x.dtype, device=dev)
        self.residual = None if residual is None else residual.clone()
        self.anchors = None if anchors is None else tuple(
            t.clone() for t in anchors)
        self.lr0, self.step_size, self.gamma = float(lr), step_size, gamma
        self.lr = torch.tensor(float(lr), dtype=torch.float32, device=dev)
        self.opt = torch.optim.Adam(self.flat, lr=self.lr, eps=ADAM_EPS,
                                    capturable=True, foreach=True)
        for p in self.flat:
            self.opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=dev),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
        self.graph = self.loss = None

    def _update(self) -> torch.Tensor:
        if self.step_size is not None:
            count = self.opt.state[self.flat[0]]["step"]
            self.lr.copy_(self.lr0 * torch.pow(
                torch.full_like(count, self.gamma),
                torch.floor(count / self.step_size)))
        loss = surface_loss(self.pairs, self.x, self.y, self.residual,
                            self.anchors)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def run(self, net, opt_state: AdamState, x, y, residual, anchors,
            iters: int):
        """``iters`` updates from (net, opt_state): the load into the
        static copies, the eager warm-up and the capture where the graph is
        new, the replays, the snapshot; each phase a span."""
        moments = ([t for pair in opt_state.mu for t in pair],
                   [t for pair in opt_state.nu for t in pair])
        with span("fit_chunk.load"), torch.no_grad():
            for dst, src in zip(self.flat,
                                [t for pair in _layers(net) for t in pair]):
                dst.copy_(src)
            for dst, src in ((self.x, x), (self.y, y),
                             (self.residual, residual)):
                if dst is not None:
                    dst.copy_(src)
            for dst, src in zip(self.anchors or (), anchors or ()):
                dst.copy_(src)
            for p, m, v in zip(self.flat, *moments):
                st = self.opt.state[p]
                st["exp_avg"].copy_(m)
                st["exp_avg_sq"].copy_(v)
                st["step"].fill_(float(opt_state.count))
        losses = []
        n_eager = 0 if self.graph is not None else min(self.WARMUP, iters)
        if n_eager:
            with span("fit_chunk.warmup"):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(n_eager):
                        self.opt.zero_grad(set_to_none=True)
                        losses.append(self._update())
                torch.cuda.current_stream().wait_stream(side)
        if iters > n_eager and self.graph is None:
            with span("fit_chunk.capture"):
                self.opt.zero_grad(set_to_none=True)
                self.graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(self.graph):
                        self.loss = self._update()
                except RuntimeError as exc:
                    raise RuntimeError(
                        "fit_chunk: capturing the Adam update as a CUDA "
                        f"graph failed ({exc})") from exc
        with span("fit_chunk.replay"):
            for _ in range(iters - n_eager):
                self.graph.replay()
                losses.append(self.loss.clone())
        count("fit_chunk.updates_eager", n_eager)
        count("fit_chunk.updates_replayed", iters - n_eager)
        with span("fit_chunk.snapshot"):
            net, state = _snapshot(self.flat, self.opt,
                                   opt_state.count + iters)
        return net, state, (torch.stack(losses) if losses
                            else x.new_empty(0))


def fit_surface(net, x: torch.Tensor, y: torch.Tensor,
                residual: torch.Tensor | None = None, anchors=None, *,
                iters: int = 4000, lr: float = 1e-3,
                step_size: int | None = 100,
                gamma: float = 0.9) -> TrainResult:
    """Full-batch Adam on the surface regression from a fresh state."""
    opt_state = init_opt_state(net, lr, step_size, gamma)
    net, _, losses = fit_chunk(net, opt_state, x, y, residual, anchors,
                               iters=iters, lr=lr, step_size=step_size,
                               gamma=gamma)
    return TrainResult(params=net, losses=losses)


# ---------------------------------------------------------------------------
# Pretrain target surfaces
# ---------------------------------------------------------------------------


def _grid(v_lo, v_hi, a, n, device):
    v = torch.linspace(v_lo, v_hi, n, dtype=torch.float32, device=device)
    return torch.meshgrid(v, a, indexing="ij")


def pretrain_grid_s(p: HHParams, n: int = 50, device=None):
    """The s/d-study pretrain grid: V in [-140, 80], a in [0, 1], target the
    shifted analytic HH surface (k1 * 0.9, k2 * 1.1)."""
    device = resolve_device(device)
    a = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
    vv, aa = _grid(-140.0, 80.0, a, n, device)
    k1 = float(p.p1) * torch.exp(float(p.p2) * vv) * 0.9
    k2 = float(p.p3) * torch.exp(-float(p.p4) * vv) * 1.1
    yy = k1 * (1.0 - aa) - k2 * aa
    x = torch.stack([vv.reshape(-1) / VRANGE, aa.reshape(-1)], dim=-1)
    return x, yy.reshape(-1)


def pretrain_grid_r(p: HHParams, n: int = 100, device=None):
    """The r-study pretrain grid: V in [-140, 80], a in [-0.5, 1.5], the
    exact analytic surface of p1-p4."""
    device = resolve_device(device)
    a = torch.linspace(-0.5, 1.5, n, dtype=torch.float32, device=device)
    vv, aa = _grid(-140.0, 80.0, a, n, device)
    yy = a_gate_rhs(p, aa, vv)
    x = torch.stack([vv.reshape(-1) / VRANGE, aa.reshape(-1)], dim=-1)
    return x, yy.reshape(-1)


def pretrain(net, p: HHParams, kind: str = "s", iters: int = 1000,
             lr: float = 1e-3) -> TrainResult:
    """Adam pretrain (constant rate) towards the analytic surface, on the
    device of net's weights."""
    device = _layers(net)[0][0].device
    if kind == "s":
        x, y = pretrain_grid_s(p, device=device)
    elif kind == "r":
        x, y = pretrain_grid_r(p, device=device)
    else:
        raise ValueError(kind)
    return fit_surface(net, x, y, iters=iters, lr=lr, step_size=None)


def boundary_anchors(base: HHParams | None, weight: float = 1.0,
                     n_v: int = 45, n_a: int = 12, device=None):
    """Out-of-hull anchor grid (x_a, y_a, weight): V in [-140, 80] x a in
    [-0.5, -0.08] u [1.08, 1.5], target the analytic surface of ``base``
    (NN-f) or 0 (NN-d and residual nets: fall back to the analytic part)."""
    device = resolve_device(device)
    f32 = torch.float32
    a = torch.cat([
        torch.linspace(-0.5, -0.08, n_a // 2, dtype=f32, device=device),
        torch.linspace(1.08, 1.5, n_a - n_a // 2, dtype=f32, device=device),
    ])
    vv, aa = _grid(-140.0, 80.0, a, n_v, device)
    x = torch.stack([vv.reshape(-1) / VRANGE, aa.reshape(-1)], dim=-1)
    if base is None:
        y = torch.zeros(x.shape[0], dtype=f32, device=device)
    else:
        y = a_gate_rhs(base, x[:, 1], x[:, 0] * VRANGE)
    return x, y, torch.tensor(weight, dtype=f32, device=device)
