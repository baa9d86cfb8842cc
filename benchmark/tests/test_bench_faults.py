"""A run driven end to end at a toy size on the CPU (the program's plain
versions in place of its kernels), with the timed path broken underneath:
``correct`` has to come out false for each fault the cell can have, and
true without one.  One card, so no exchange between chips can be left
out."""

import copy
import json
import os

import pytest
import torch

from benchmark import harness as H
from benchmark import run

SEED = 2**32 + 11


def tiny_validate_mix():
    mix = copy.deepcopy(H.load_json("traffic", "table1-64"))
    mix["members"] = 2
    recs = []
    for r in mix["recordings"][:2]:
        r = dict(r, n=3000, first=100, period=1400, test_mv=r["test_mv"][-2:],
                 sweep=[[0, -120.0], [100, -80.0], [300, "test"],
                        [900, -40.0], [1100, -120.0], [1300, -80.0]])
        recs.append(r)
    mix["recordings"] = recs
    mix["spans"] = {}
    mix["solver"] = dict(trips=2048, seg_samples=1500, chunk=512, rtol=1e-6,
                         atol=1e-8)
    return mix


def tiny_surface_mix():
    mix = copy.deepcopy(H.load_json("traffic", "d2-surface"))
    mix.update(points=400, chunk=4, step_size=8)
    return mix


def tiny_node_mix():
    mix = copy.deepcopy(H.load_json("traffic", "act20"))
    mix.update(t_end_ms=1050.0, outputs=8)
    mix["pretrain"]["iters"] = 20
    return mix


def correct(workload, mix, device="cpu"):
    torch.set_num_threads(2)
    return run.main(["--workload", workload, "--seed", str(SEED),
                     "--seconds", "0.01"], mix=mix, device=device)["correct"]


def _state_unchanged(monkeypatch):
    from ionflux_torch.ops import fused_solve as F

    attempt = F._dp5_attempt

    def stuck(rhs_all, t, y, f, h_eff):
        ks, _, err = attempt(rhs_all, t, y, f, h_eff)
        return ks, y, torch.zeros_like(err)

    monkeypatch.setattr(F, "_dp5_attempt", stuck)


def _half_batch(monkeypatch):
    from ionflux_torch import eval as E

    score = E.population_rollout_maes

    def half(kind, pop, *a, **kw):
        net = type(pop.net)([(w[:1], b[:1]) for w, b in pop.net.layers])
        out = score(kind, type(pop)(net, pop[1]), *a, **kw)
        return out.repeat(2, axis=0)

    monkeypatch.setattr(E, "population_rollout_maes", half)


def _answer_altered(monkeypatch):
    from ionflux_torch import eval as E

    score = E.population_rollout_maes

    def altered(*a, **kw):
        out = score(*a, **kw).copy()
        out[0, 0] *= 1.01
        return out

    monkeypatch.setattr(E, "population_rollout_maes", altered)


@pytest.mark.parametrize("workload", ["nnf.validate", "nnd.validate"])
def test_validate_sound_run_is_correct(workload):
    assert correct(workload, tiny_validate_mix())


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_validate_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not correct("nnf.validate", tiny_validate_mix())


def _adam_skips(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)


def _surface_half(monkeypatch):
    from ionflux_torch.fit import train as T

    loss = T.surface_loss

    def half(net, x, y, residual=None, anchors=None):
        n = x.shape[0] // 2
        return 2.0 * loss(net, x[:n], y[:n],
                          None if residual is None else residual[:n], anchors)

    monkeypatch.setattr(T, "surface_loss", half)


def _surface_altered(monkeypatch):
    from ionflux_torch.fit import train as T

    loss = T.surface_loss
    monkeypatch.setattr(T, "surface_loss",
                        lambda *a, **k: loss(*a, **k) * 1.01)


def test_surface_sound_run_is_correct():
    assert correct("nnd.train", tiny_surface_mix())


@pytest.mark.parametrize("fault", [_adam_skips, _surface_half,
                                   _surface_altered])
def test_surface_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not correct("nnd.train", tiny_surface_mix())


def _replay_unchanged(monkeypatch):
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", lambda self: None)


def _replay_stale_rate(monkeypatch):
    from ionflux_torch.fit import train as T

    update = T._UpdateGraph._update

    def stale(self):
        step, self.step_size = self.step_size, None
        try:
            return update(self)
        finally:
            self.step_size = step

    monkeypatch.setattr(T._UpdateGraph, "_update", stale)


def _replay_half(monkeypatch):
    from ionflux_torch.fit import train as T

    update = T._UpdateGraph._update

    def half(self):
        if not torch.cuda.is_current_stream_capturing():
            return update(self)
        n = self.x.shape[0] // 2
        keep = (self.x, self.y, self.residual)
        self.x, self.y = self.x[:n], self.y[:n]
        self.residual = None if self.residual is None else self.residual[:n]
        try:
            return 2.0 * update(self)
        finally:
            self.x, self.y, self.residual = keep

    monkeypatch.setattr(T._UpdateGraph, "_update", half)


@pytest.mark.cuda
def test_surface_graph_sound_run_is_correct(card):
    assert correct("nnd.train", H.load_json("traffic", "d2-surface"), card)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_replay_unchanged, _replay_stale_rate,
                                   _replay_half])
def test_surface_graph_fault_is_not_correct(fault, card, monkeypatch):
    """Faults of the update graph's capture and replays alone (the eager
    start is sound), at the cell's own size on the card."""
    fault(monkeypatch)
    assert not correct("nnd.train", H.load_json("traffic", "d2-surface"),
                       card)


def _node_half(monkeypatch):
    from benchmark.drivers import node_train as ND

    make = ND._trainer_module

    def patched():
        mod = make()
        loss_of = mod.Trainer._loss_of

        def half(self, ys):
            n = ys.shape[0] // 2
            keep = (self.v_t, self.data)
            self.v_t, self.data = self.v_t[:n], self.data[:n]
            try:
                return loss_of(self, ys[:n])
            finally:
                self.v_t, self.data = keep
        mod.Trainer._loss_of = half
        return mod

    monkeypatch.setattr(ND, "_trainer_module", patched)


def _node_altered(monkeypatch):
    from benchmark.drivers import node_train as ND

    make = ND._trainer_module

    def patched():
        mod = make()
        loss_of = mod.Trainer._loss_of
        mod.Trainer._loss_of = lambda self, ys: loss_of(self, ys) * 1.01
        return mod

    monkeypatch.setattr(ND, "_trainer_module", patched)


def test_node_sound_run_is_correct():
    assert correct("nnf.node_train", tiny_node_mix())


@pytest.mark.parametrize("fault", [_adam_skips, _node_half, _node_altered])
def test_node_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not correct("nnf.node_train", tiny_node_mix())
