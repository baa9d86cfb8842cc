"""Neural-ODE training through the solve: ``Trainer.step()`` of
scripts/train_neural_ode_torch.py in RK4 mode, one Adam update of NN-f on
a current trace with the gradient taken interval by interval (the RK4
interval's forward and vector-Jacobian product, each one CUDA graph
replayed for every output interval).

Set-up makes the trace, the initial net and its pretrain on the device
from the seed (the pretrain with the reference's own loss and Adam), builds
the trainer and drives it through its first two updates (the first of
which captures the trainer's two graphs), which the reference follows; the
window's updates continue from there."""

from __future__ import annotations

import importlib.util
import math
import os

import numpy as np
import torch

from benchmark import flops, gen
from benchmark.drivers.surface_train import loss_gap, norm_gap
from benchmark.reference import train as RT

COMPARED_STEPS = 2      # the reference follows two updates: shorter than
                        # the window (three take ~3 x its time to run)


def _trainer_module():
    path = os.path.join(gen.ROOT, "scripts", "train_neural_ode_torch.py")
    spec = importlib.util.spec_from_file_location("train_neural_ode_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def truth_current(gate, knots: np.ndarray, knot_dt: float, ts: np.ndarray,
                  h: float, g: float, e: float) -> np.ndarray:
    """The analytic HH model's current at ts from rest (a = 0, r = 1), by
    RK4 at step h on the interpolated knots, float64 on the host."""
    p = [float(x) for x in gate]

    def volt(t):
        x = min(max(t / knot_dt, 0.0), len(knots) - 1.0)
        i = min(int(math.floor(x)), len(knots) - 2)
        return knots[i] + (x - i) * (knots[i + 1] - knots[i])

    def f(t, a, r):
        v = volt(t)
        k1, k2 = p[0] * math.exp(p[1] * v), p[2] * math.exp(-p[3] * v)
        k3, k4 = p[4] * math.exp(p[5] * v), p[6] * math.exp(-p[7] * v)
        return k1 * (1 - a) - k2 * a, -k3 * r + k4 * (1 - r)

    out, a, r, t = [], 0.0, 1.0, 0.0
    for k, tk in enumerate(ts):
        if k:
            n = max(1, int(round((tk - t) / h)))
            hh = (tk - t) / n
            for _ in range(n):
                a1, r1 = f(t, a, r)
                a2, r2 = f(t + hh / 2, a + hh / 2 * a1, r + hh / 2 * r1)
                a3, r3 = f(t + hh / 2, a + hh / 2 * a2, r + hh / 2 * r2)
                a4, r4 = f(t + hh, a + hh * a3, r + hh * r3)
                a += hh / 6 * (a1 + 2 * a2 + 2 * a3 + a4)
                r += hh / 6 * (r1 + 2 * r2 + 2 * r3 + r4)
                t += hh
            t = tk
        out.append(g * a * r * (volt(tk) - e))
    return np.array(out)


def inputs(cell):
    """(knots [K] float32, knot dt, ts [T] float32, y0, data [T] float32,
    pretrained leaves [W, b, ...] float32), all on the device."""
    mix, cfg, dev = cell.mix, cell.config, cell.device
    knots = gen.step_recording(mix["protocol"])
    kdt = float(mix["protocol"]["dt_ms"])
    ts = np.linspace(0.0, float(mix["t_end_ms"]), int(mix["outputs"]))
    ts32 = torch.tensor(ts, dtype=torch.float32, device=dev)
    truth = truth_current(mix["truth_gate"], knots, kdt,
                          ts32.double().cpu().numpy(), float(mix["truth_h_ms"]),
                          float(mix["g"]), float(mix["e_mv"]))
    noise = gen.noise_traces([len(ts)], float(mix["target_sigma"]),
                             cell.seed, dev)[0]
    data = torch.as_tensor(truth, dtype=torch.float32, device=dev) + noise
    init = gen.mlp_weights(cfg["sizes"], float(mix["init_std"]), cell.seed,
                           dev)
    leaves = pretrain([t for pair in init for t in pair], mix, dev)
    y0 = torch.tensor([0.0, 1.0], dtype=torch.float32, device=dev)
    return (torch.as_tensor(knots, dtype=torch.float32, device=dev), kdt,
            ts32, y0, data, leaves)


def pretrain(leaves, mix, dev):
    """The studies' pretrain stage, by the reference's loss and Adam in
    float32: the MLP towards a shifted analytic a-gate surface (k1 x 0.9,
    k2 x 1.1) on an n x n grid of V in [-140, 80] mV and a in [0, 1], at a
    constant rate."""
    pt = mix["pretrain"]
    n = int(pt["grid"])
    v = torch.linspace(-140.0, 80.0, n, dtype=torch.float32, device=dev)
    a = torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=dev)
    vv, aa = torch.meshgrid(v, a, indexing="ij")
    p = [float(x) for x in mix["truth_gate"]]
    k1 = p[0] * torch.exp(p[1] * vv) * 0.9
    k2 = p[2] * torch.exp(-p[3] * vv) * 1.1
    y = (k1 * (1.0 - aa) - k2 * aa).reshape(-1)
    x = torch.stack([vv.reshape(-1) / 100.0, aa.reshape(-1)], dim=-1)
    lr = float(pt["lr"])
    opt = RT.Adam(leaves, lambda k: lr)
    for _ in range(int(pt["iters"])):
        cur = [t.clone().requires_grad_(True) for t in opt.leaves]
        grads = torch.autograd.grad(RT.surface_loss(cur, x, y, None), cur)
        opt.step([gr.detach() for gr in grads])
    return [t.detach().contiguous() for t in opt.leaves]


class Run:
    def __init__(self, cell):
        from ionflux_torch import protocols as P

        self.cell = cell
        mix = cell.mix
        self.NO = NO = _trainer_module()
        knots, kdt, ts, y0, data, leaves = inputs(cell)
        self.inputs = (knots, kdt, ts, y0, data, leaves)
        proto = P.Protocol(torch.tensor(0.0, device=cell.device),
                           torch.tensor(kdt, device=cell.device), knots)
        self.tr = NO.Trainer(list(zip(leaves[0::2], leaves[1::2])), proto,
                             ts, y0, data, adjoint=False)
        losses = [float(self.tr.step())]
        # the first gradient as Adam holds it after one update (a moment
        # that is missing reads as a zero gradient)
        self.first_grad = [
            self.tr.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            .detach().clone() / (1 - RT.BETA1) for p in self.tr.flat]
        losses += [float(self.tr.step()) for _ in range(COMPARED_STEPS - 1)]
        self.losses = losses
        self.change = [p.detach() - q for p, q in zip(self.tr.flat, leaves)]
        self.rhs_evals = ((int(mix["outputs"]) - 1) * int(NO.RK4_SUB)
                          * flops.RK4_STAGES)

    def call(self):
        loss = float(self.tr.step())
        return 1, 1, int(not math.isfinite(loss))

    def trace_info(self) -> dict:
        return {"call_ops": flops.node_update_ops(
            self.cell.config["sizes"], self.rhs_evals)}

    def check(self):
        lim = self.cell.workload["limits"]
        self.tr = None
        ref = reference(self.cell, self.inputs, int(self.NO.RK4_SUB),
                        float(self.NO.LR))
        return compare(self.losses, self.first_grad, self.change, ref, lim)


def reference(cell, inputs, n_sub, lr, *, dtype=torch.float64, tf32=False,
              products=None):
    """(losses, first gradient, change after the compared steps) of the
    plain reference in ``dtype`` (products in ``products`` where given)."""
    knots, kdt, ts, y0, data, leaves = inputs
    mix = cell.mix
    gate = [float(x) for x in mix["truth_gate"]]
    kn, tsd, y0d, dd = (knots.double(), ts.double(), y0.to(dtype),
                        data.to(dtype))
    losses, first, last, _ = RT.first_steps(
        lambda ls: RT.node_loss(ls, gate, kn, kdt, tsd, y0d, dd, n_sub,
                                float(mix["g"]), float(mix["e_mv"]),
                                products),
        leaves, lambda k: lr, COMPARED_STEPS, dtype=dtype, tf32=tf32)
    return losses, first, [a - b.to(dtype) for a, b in zip(last, leaves)]


def compare(losses, first_grad, change, ref, lim):
    r_losses, r_first, r_change = ref
    return [("loss_gap", loss_gap(losses, r_losses), float(lim["loss_gap"])),
            ("grad_gap", norm_gap(first_grad, r_first),
             float(lim["grad_gap"])),
            ("change_gap", norm_gap(change, r_change),
             float(lim["change_gap"]))]


def setup(cell) -> Run:
    return Run(cell)


def control(cell, seeds) -> dict:
    """The control's readings on each seed: the reference put in the
    program's place with its products in bfloat16 (the trainer's products
    are one-row matrix-vector products, which TF32 leaves in full float32,
    so the nearest lower precision that changes them is bfloat16), judged
    against the float64 reference; beside it the reference in full
    float32, which the limits have to pass."""
    NO = _trainer_module()
    out = {}
    for seed in seeds:
        cell.seed = seed
        ins = inputs(cell)
        ref = reference(cell, ins, int(NO.RK4_SUB), float(NO.LR))
        out[seed] = {
            name: {n: v for n, v, _ in compare(
                *reference(cell, ins, int(NO.RK4_SUB), float(NO.LR),
                           dtype=torch.float32, products=low),
                ref, cell.workload["limits"])}
            for name, low in (("bf16", torch.bfloat16), ("f32", None))}
    return out
