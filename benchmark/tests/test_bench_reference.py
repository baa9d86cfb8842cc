"""The plain reference against closed forms on tiny cases."""

import math

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.reference import models as RM
from benchmark.reference import ode as RO
from benchmark.reference import train as RT
from benchmark.reference import validate as RV

F64 = torch.float64


def test_dopri5_lanes_decay_each_lane_its_own_rate():
    k = torch.tensor([0.5, 2.0, 10.0], dtype=F64)
    t_end = torch.tensor([3.0, 1.0, 2.0], dtype=F64)
    y0 = torch.ones((3, 1), dtype=F64)
    steps = RO.dopri5_lanes(lambda t, y: -k[:, None] * y, y0, t_end,
                            rtol=1e-10, atol=1e-12, h0=0.01, h_max=1.0)
    tau = torch.stack([torch.linspace(0, float(t), 17, dtype=F64)
                       for t in t_end])
    y = steps.at(torch.arange(3), tau)[..., 0]
    want = torch.exp(-k[:, None] * tau)
    assert float((y - want).abs().max()) < 1e-8


def test_dopri5_dense_output_is_fourth_order():
    # y' = cos t on one big step: the continuous extension is exact to
    # O(h^5) everywhere inside the step
    steps = RO.dopri5_lanes(lambda t, y: torch.cos(t)[:, None],
                            torch.zeros((1, 1), dtype=F64),
                            torch.tensor([0.2], dtype=F64), rtol=1e-3,
                            atol=1e-3, h0=0.2, h_max=0.2)
    tau = torch.linspace(0, 0.2, 9, dtype=F64)[None]
    y = steps.at(torch.arange(1), tau)[0, :, 0]
    assert float((y - torch.sin(tau[0])).abs().max()) < 1e-7


def test_rk4_linear_ode():
    ts = torch.linspace(0, 1, 5, dtype=F64)
    ys = RO.rk4(lambda t, y: -2.0 * y, torch.ones(1, dtype=F64), ts, 50)
    assert float((ys[:, 0] - torch.exp(-2 * ts)).abs().max()) < 1e-9


def test_gate_relaxes_to_steady_state_at_constant_voltage():
    # NN-d with a zero net is the analytic HH gate: a(t) = a_inf (1 -
    # exp(-t / tau)) from a = 0 at constant V; r(t) likewise from r = 1
    p = [1e-4, 0.08, 3e-5, 0.05, 0.09, 0.02, 0.008, 0.025]
    v = 20.0
    layers = [(torch.zeros(1, 2, 3, dtype=F64), torch.zeros(1, 3, dtype=F64)),
              (torch.zeros(1, 3, 1, dtype=F64), torch.zeros(1, 1, dtype=F64))]
    k1, k2 = p[0] * math.exp(p[1] * v), p[2] * math.exp(-p[3] * v)
    k3, k4 = p[4] * math.exp(p[5] * v), p[6] * math.exp(-p[7] * v)

    def rhs(t, y):
        vv = torch.full(y.shape[:1], v, dtype=F64)[None]
        return RM.gate_rhs("nnd", layers, p, y[None], vv)[0]

    steps = RO.dopri5_lanes(rhs, torch.tensor([[0.0, 1.0]], dtype=F64),
                            torch.tensor([500.0], dtype=F64), rtol=1e-10,
                            atol=1e-12, h0=0.1, h_max=50.0)
    tau = torch.linspace(0, 500, 11, dtype=F64)[None]
    y = steps.at(torch.arange(1), tau)[0]
    a = k1 / (k1 + k2) * (1 - torch.exp(-(k1 + k2) * tau[0]))
    r_inf = k4 / (k3 + k4)
    r = r_inf + (1 - r_inf) * torch.exp(-(k3 + k4) * tau[0])
    assert float((y[:, 0] - a).abs().max()) < 1e-9
    assert float((y[:, 1] - r).abs().max()) < 1e-9


def test_rollout_maes_of_a_silent_net_is_the_targets_mean():
    # NN-f with a zero net keeps a = 0: I = 0 and each MAE is mean |target|
    # over the span
    layers = [(torch.zeros(2, 2, 4), torch.zeros(2, 4)),
              (torch.zeros(2, 4, 1), torch.zeros(2, 1))]
    p = [0.0] * 4 + [0.09, 0.02, 0.008, 0.025]
    vs = [torch.tensor(gen.step_recording(
        {"n": 400, "hold_mv": -80.0, "first": 50, "period": 200,
         "sweep": [[0, -120.0], [20, "test"]], "test_mv": [20.0, 40.0]}),
        dtype=torch.float32), torch.linspace(-80, 40, 300)]
    tg = gen.noise_traces([400, 300], 0.1, 7, "cpu")
    spans = [(0, 400), (100, 250)]
    sol = RV.solve("nnf", layers, p, vs, 0.1, rtol=1e-7, atol=1e-9)
    maes = RV.score(sol, tg, spans, 1.0, -88.4)
    for q, (lo, hi) in enumerate(spans):
        want = float(tg[q][lo:hi].double().abs().mean())
        assert torch.allclose(maes[:, q], torch.full((2,), want,
                                                     dtype=F64), rtol=1e-12)


def test_adam_matches_the_textbook_first_step():
    # the first Adam step moves every weight by lr sign(g) (to eps)
    leaves = [torch.tensor([1.0, -2.0, 3.0], dtype=F64)]
    opt = RT.Adam(leaves, lambda k: 0.01)
    opt.step([torch.tensor([0.5, -3.0, 0.0], dtype=F64)])
    assert torch.allclose(opt.leaves[0],
                          torch.tensor([0.99, -1.99, 3.0], dtype=F64),
                          atol=1e-9)


def test_adam_matches_torch_optim_over_steps():
    w = torch.randn(5, dtype=F64, generator=torch.Generator().manual_seed(3))
    ref = w.clone().requires_grad_(True)
    opt_t = torch.optim.Adam([ref], lr=0.05, eps=1e-8)
    opt = RT.Adam([w], lambda k: 0.05)
    for _ in range(4):
        g = 2 * opt.leaves[0] - 1.0
        opt.step([g])
        opt_t.zero_grad()
        (ref ** 2 - ref).sum().backward()
        opt_t.step()
    assert torch.allclose(opt.leaves[0], ref.detach(), rtol=1e-12, atol=0)


def test_interp_is_linear_between_knots_and_held_outside():
    v = torch.tensor([0.0, 10.0, 30.0], dtype=F64)
    t = torch.tensor([-1.0, 0.0, 0.5, 1.5, 2.0, 9.0], dtype=F64)
    assert RM.interp(v, 1.0, t).tolist() == [0.0, 0.0, 5.0, 20.0, 30.0,
                                             30.0]


def test_step_recording_by_hand():
    v = gen.step_recording({"n": 12, "hold_mv": -80.0, "first": 2,
                            "period": 5, "sweep": [[0, -120.0], [2, "test"]],
                            "test_mv": [10.0, 20.0]})
    assert v.tolist() == [-80, -80, -120, -120, 10, 10, 10, -120, -120,
                          20, 20, 20]


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    a = gen.noise_traces([50], 0.1, 2**33 + 1, "cpu")[0]
    b = gen.noise_traces([50], 0.1, 2**33 + 1, "cpu")[0]
    c = gen.noise_traces([50], 0.1, 2**33 + 2, "cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    la = gen.mlp_weights([2, 3, 1], 0.1, 5, "cpu")
    lb = gen.mlp_weights([2, 3, 1], 0.1, 5, "cpu")
    assert all(torch.equal(x, y) for p, q in zip(la, lb)
               for x, y in zip(p, q))
    assert np.isclose(float(la[0][0].std()), 0.1, rtol=1.0)
