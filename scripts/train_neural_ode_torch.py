#!/usr/bin/env python
"""Neural-ODE training through the solve, on the ionflux_torch port: fit
NN-f straight to current traces by Adam, backpropagating THROUGH the ODE
solve (the counterpart of ``scripts/train_neural_ode.py``).

    python3 scripts/train_neural_ode_torch.py --protocol act [--adjoint]
        [--iters N] [--device cpu]

The data: the HH_B06 ground-truth current at 301 output times up to
min(T_END, 3000) ms plus ``NOISE_SIGMA`` noise (a seed-0
``torch.Generator``).  The net: ``nnf_init`` at full width (2-200x5-1),
pretrained on the s-study surface (500 Adam updates).  Training: Adam at
3e-4 on the trace MSE through ``odeint_rk4(n_sub=8)``, or through
``odeint_adjoint(rtol 1e-4, atol 1e-6)`` with ``--adjoint``.  Prints the
final MAE against the clean truth and writes ``model.npz`` (the JAX
package's leaf layout) to --outdir (default out/neural-ode-torch).

``--protocol ap2hz`` (the default, as in JAX) reads
``$IONFLUX_REFERENCE/test-protocols/ap2hz.csv`` and fails, naming the file,
where it is absent; any other value takes the 20 mV activation protocol at
1 ms knots.  Runs on the card unless ``--device cpu`` is given.  On the card
an RK4-mode update runs two hand-written kernels, the solve's forward pass
and its vector-Jacobian product (``ops/node_rk4.py``), where the net fits
their cluster, and else replays two CUDA graphs, the RK4 interval's forward
and its vector-Jacobian product, 300 times each (``Trainer``); the adjoint
mode runs around the solves' own captured blocks.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from common_torch import ROOT, parse, study_parser  # noqa: E402

from ionflux_torch import protocols as P  # noqa: E402
from ionflux_torch._device import resolve_device  # noqa: E402
from ionflux_torch.data import simulate_current  # noqa: E402
from ionflux_torch.fit.train import pretrain  # noqa: E402
from ionflux_torch.models import nnf_init, nnf_rhs  # noqa: E402
from ionflux_torch.models.nn import MLP, NNfParams  # noqa: E402
from ionflux_torch.models.registry import HH_B06, SYNTHETIC  # noqa: E402
from ionflux_torch.observe import add_noise, gate_current, mae  # noqa: E402
from ionflux_torch.ops import node_rk4 as NR  # noqa: E402
from ionflux_torch.solver import odeint_adjoint, odeint_rk4  # noqa: E402
from ionflux_torch.solver.fixed import _interval  # noqa: E402
from ionflux_torch.studies import REFDIR  # noqa: E402
from ionflux_torch.utils.ckpt import save_pytree  # noqa: E402
from ionflux_torch.utils.timing import count, span  # noqa: E402

LR = 3e-4
RK4_SUB = 8
ADJ_TOL = (1e-4, 1e-6)    # rtol, atol of the adjoint's solves


def rhs(t, y, args):
    """NN-f on the protocol: args = (net [(W, b), ...], protocol)."""
    net, proto = args
    return nnf_rhs(NNfParams(net, HH_B06), t, y, P.voltage(proto, t))


def solve(net, proto, ts, y0, adjoint: bool) -> torch.Tensor:
    """States [T, 2] of the net on the protocol, by the training solver."""
    if adjoint:
        return odeint_adjoint(rhs, y0, ts, (net, proto), *ADJ_TOL)
    return odeint_rk4(rhs, y0, ts, (net, proto), n_sub=RK4_SUB)


def load_protocol(name: str, device) -> P.Protocol:
    if name != "ap2hz":
        return P.activation_protocol(20.0, dt_ms=1.0, device=device)
    path = os.path.join(REFDIR or "", "test-protocols", "ap2hz.csv")
    if not (REFDIR and os.path.exists(path)):
        raise FileNotFoundError(
            f"--protocol ap2hz reads {path!r} (the reference checkout, named "
            f"by IONFLUX_REFERENCE), which is not there; pass --protocol act "
            f"for the activation protocol")
    return P.load_csv(path, device=device)


class Trainer:
    """Adam on the trace MSE through the solve; ``step()`` is one update.

    RK4 mode takes the gradient interval by interval, as a rematerialised
    backward pass does: the forward pass keeps the state at each output
    time; the backward pass recomputes each interval and takes its
    vector-Jacobian product, last interval first, adding each interval's
    parameter gradient into ``acc``.  On the card (with ``graph``) an
    update takes one of two paths, by what the trainer can observe:

    - ``fused``: where the net's slices fit the kernels' cluster (the size
      rule ``ops/node_rk4.py::node_cluster``), the whole solve's forward
      pass and its vector-Jacobian product are one kernel launch each
      (``NodeRK4``), summing each interval's parameter gradient as the
      graphs do; the results differ from the graphs' only in float32
      summation order;
    - else the interval's forward and its vector-Jacobian product are each
      captured once as a CUDA graph (``capture_s``) and replayed 300 times
      an update; the graphs read the trainer's own parameters, which Adam
      updates in place.

    ``graph=False`` runs the same code eagerly (the reference the replays
    equal bit for bit).  The adjoint mode backpropagates through
    ``odeint_adjoint`` (its solves replay their own graphs)."""

    def __init__(self, net, proto, ts, y0, data, *, adjoint: bool,
                 graph: bool = True):
        self.flat = [x.detach().clone().requires_grad_(True)
                     for pair in net for x in pair]
        self.proto, self.ts, self.y0, self.data = proto, ts, y0, data
        self.v_t = P.voltage(proto, ts)
        self.adjoint = adjoint
        cuda = ts.device.type == "cuda"
        if cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("neural-ODE training runs in float32: set "
                               "torch.backends.cuda.matmul.allow_tf32 = "
                               "False")
        self.opt = torch.optim.Adam(self.flat, lr=LR, eps=1e-8,
                                    capturable=cuda, foreach=cuda)
        self.acc = [torch.zeros_like(p) for p in self.flat]
        self.graphs = None                # (forward, vjp) once captured
        sizes = [int(self.flat[0].shape[0])] + [int(w.shape[1])
                                                for w in self.flat[0::2]]
        on_card = cuda and graph and not adjoint
        self.fused = on_card and NR.node_cluster(sizes, RK4_SUB) > 0
        self.use_graphs = on_card and not self.fused
        self.capture_s = None             # host seconds the capture took
        if self.fused:
            self.plan = NR.Plan(sizes, RK4_SUB, HH_B06, ts.device)

    @property
    def net(self) -> list:
        return list(zip(self.flat[0::2], self.flat[1::2]))

    def _loss_of(self, ys):
        return torch.mean((gate_current(ys, self.v_t, SYNTHETIC)
                           - self.data) ** 2)

    def loss(self) -> torch.Tensor:
        """The trace MSE by the training solver, differentiable in the
        net by autograd (through ``odeint_rk4`` or the adjoint)."""
        return self._loss_of(solve(self.net, self.proto, self.ts, self.y0,
                                   self.adjoint))

    def _fwd(self, y, t0, t1):
        with torch.no_grad():
            return _interval(rhs, (self.net, self.proto), RK4_SUB, y, t0, t1)

    def _vjp(self, y, t0, t1, g):
        """The interval's cotangent at its start for g at its end; its
        parameter gradient is added into acc."""
        with torch.enable_grad():
            yy = y.detach().requires_grad_(True)
            y1 = _interval(rhs, (self.net, self.proto), RK4_SUB, yy, t0, t1)
            grads = torch.autograd.grad(y1, [yy] + self.flat, g)
        torch._foreach_add_(self.acc, list(grads[1:]))
        return grads[0]

    def _capture(self) -> None:
        """Capture the interval's forward and vector-Jacobian product on
        static inputs, after one eager run of each (on a side stream)."""
        t = time.perf_counter()
        with span("node.capture"):
            self._in = [self.y0.clone(), self.ts[0].clone(),
                        self.ts[1].clone(), torch.zeros_like(self.y0)]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fwd(*self._in[:3])
                self._vjp(*self._in)
            torch.cuda.current_stream().wait_stream(side)
            fwd, vjp = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(fwd):
                    self._out_fwd = self._fwd(*self._in[:3])
                with torch.cuda.graph(vjp):
                    self._out_vjp = self._vjp(*self._in)
            except RuntimeError as exc:
                raise RuntimeError("train_neural_ode: capturing the RK4 "
                                   f"interval as a CUDA graph failed "
                                   f"({exc})") from exc
        self.graphs = (fwd, vjp)
        self.capture_s = time.perf_counter() - t
        print(f"captured the RK4 interval's forward and vector-Jacobian "
              f"product as CUDA graphs in {self.capture_s:.1f} s")

    def _replay(self, which: int, *inputs) -> torch.Tensor:
        for dst, src in zip(self._in, inputs):
            dst.copy_(src)
        self.graphs[which].replay()
        return (self._out_fwd, self._out_vjp)[which].clone()

    def states(self) -> torch.Tensor:
        """ys [T, S] of the current net by the RK4 intervals (no grad)."""
        if self.fused:
            with torch.no_grad():
                return NR.node_rk4(self.plan, self.proto, self.ts, self.y0,
                                   self.flat)
        if self.use_graphs and self.graphs is None:
            self._capture()
        ys, y = [self.y0], self.y0
        for k in range(self.ts.shape[0] - 1):
            t0, t1 = self.ts[k], self.ts[k + 1]
            y = (self._replay(0, y, t0, t1) if self.graphs
                 else self._fwd(y, t0, t1))
            ys.append(y)
        return torch.stack(ys)

    def step(self) -> torch.Tensor:
        """One Adam update; returns its loss (before the update).  The
        update is a ``node.step`` span (``utils/timing.py``); in RK4 mode
        its phases are the spans ``node.forward`` (``states()``),
        ``node.loss``, ``node.backward`` (the interval VJPs, last first)
        and ``node.adam``, and the count ``node.fused_intervals`` reads the
        intervals the fused kernels ran (0 on the graphs or eagerly)."""
        with span("node.step", adjoint=self.adjoint):
            if self.adjoint:
                self.opt.zero_grad(set_to_none=True)
                loss = self.loss()
                loss.backward()
                self.opt.step()
                return loss.detach()
            count("node.fused_intervals",
                  self.ts.shape[0] - 1 if self.fused else 0)
            if self.fused:
                return self._fused_step()
            with span("node.forward"):
                ys = self.states()
            with span("node.loss"), torch.enable_grad():
                ys = ys.requires_grad_(True)
                loss = self._loss_of(ys)
                (g_ys,) = torch.autograd.grad(loss, ys)
            with span("node.backward"):
                torch._foreach_zero_(self.acc)
                g = g_ys[-1]
                for k in range(self.ts.shape[0] - 2, -1, -1):
                    args = (ys[k].detach(), self.ts[k], self.ts[k + 1], g)
                    g = (self._replay(1, *args) if self.graphs
                         else self._vjp(*args)) + g_ys[k]
            with span("node.adam"):
                for p, a in zip(self.flat, self.acc):
                    p.grad = a
                self.opt.step()
            return loss.detach()

    def _fused_step(self) -> torch.Tensor:
        """The fused update: ys by node_fwd, the loss and its cotangent of
        ys, every leaf's gradient by node_vjp, Adam."""
        with span("node.forward"), torch.enable_grad():
            ys = NR.node_rk4(self.plan, self.proto, self.ts, self.y0,
                             self.flat)
        with span("node.loss"), torch.enable_grad():
            loss = self._loss_of(ys)
            (g_ys,) = torch.autograd.grad(loss, ys, retain_graph=True)
        with span("node.backward"):
            grads = torch.autograd.grad(ys, self.flat, g_ys)
        with span("node.adam"):
            for p, g in zip(self.flat, grads):
                p.grad = g
            self.opt.step()
        return loss.detach()


class Run(NamedTuple):
    params: NNfParams      # the trained net (an MLP) and its r-gate
    trainer: Trainer       # the trainer that ran (its graph, optimiser)
    init: list             # the net after the pretrain, (W, b) pairs
    first: list            # the net after the first update
    losses: list           # each update's loss (before it)
    step_s: list           # host seconds of each update, synchronised
    data: torch.Tensor     # the noisy current [301]
    truth: torch.Tensor    # the clean current [301]
    final_mae: float


def main(argv=None) -> Run:
    parser = study_parser("Direct neural-ODE training through the solver, "
                          "on the ionflux_torch port.")
    parser.add_argument("--protocol", type=str, default="ap2hz")
    args = parse(parser, argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    outdir = args.outdir or os.path.join(ROOT, "out", "neural-ode-torch")
    os.makedirs(outdir, exist_ok=True)

    proto = load_protocol(args.protocol, device)
    t_end = float(proto.duration)
    ts = torch.linspace(0.0, min(t_end, 3000.0), 301, dtype=torch.float32,
                        device=device)
    y0 = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)
    truth = simulate_current(HH_B06, proto, ts, SYNTHETIC)
    data = add_noise(torch.Generator(device=device).manual_seed(0), truth)

    params = nnf_init(torch.Generator().manual_seed(0), HH_B06,
                      device=device)
    init = pretrain(params.net, HH_B06, kind="s", iters=500).params.layers
    trainer = Trainer(init, proto, ts, y0, data, adjoint=args.adjoint)

    iters = args.iters or 200
    losses, step_s, first = [], [], None
    for it in range(iters):
        t = time.perf_counter()
        losses.append(trainer.step())
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if it == 0:
            first = [(w.detach().clone(), b.detach().clone())
                     for w, b in trainer.net]
        if it % max(1, iters // 10) == 0:
            print(f"iter {it:4d} | trace MSE {float(losses[-1]):.6f}")

    net = MLP([(w.detach().clone(), b.detach().clone())
               for w, b in trainer.net])
    with torch.no_grad():
        ys = (solve(net.layers, proto, ts, y0, True) if args.adjoint
              else trainer.states())
    final_mae = float(mae(gate_current(ys, trainer.v_t, SYNTHETIC), truth))
    print(f"final | trace MSE {float(losses[-1]):.6f} | MAE vs clean truth "
          f"{final_mae:.4f} (noise floor ~0.08)")
    params = NNfParams(net, HH_B06)
    save_pytree(os.path.join(outdir, "model.npz"), params)
    return Run(params, trainer, init, first, [float(x) for x in losses],
               step_s, data, truth, final_mae)


if __name__ == "__main__":
    main()
    sys.exit(0)
