"""Checkpoint validation: ``eval.population_rollout_maes`` of a population
of member nets on recorded protocols, the call a study makes to score a
batch of checkpoints (B1 chained over segments, dense output and the MAE
reduction on the device, one CUDA graph replay a call).

The members are a checkpoint's net times (1 + spread N(0, 1)) drawn from a
fixed stream, in an order drawn from the seed, so every seed scores the
same stiffness (B1's shared controller runs the stiffest lane's steps)
and a run's work does not swing with the seed; the targets are drawn from
the seed.  Each call, set-up's too, scores the members in a new order
drawn from the seed (a study scores new checkpoints every call, so no two
calls take the same weights), and every call's MAEs, put back in the
first order, are compared with the plain reference, lane by lane."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import gen
from benchmark import spans as S
from benchmark.reference import validate as RV

POOL_SEED = 0      # the members' perturbation stream, the same every run


def inputs(cell):
    """Everything both sides take: layers [(W [P, i, o], b [P, o])], the 8
    gate scalars, recordings {name: (v, dt)}, targets {name: [N] float32 on
    the device} and spans {name: (lo, hi)}."""
    mix, dev = cell.mix, cell.device
    layers, gate = gen.population(gen.npz_leaves(cell.config["checkpoint"]),
                                  int(mix["members"]), float(mix["spread"]),
                                  POOL_SEED, dev)
    perm = torch.randperm(int(mix["members"]),
                          generator=gen.generator(cell.seed, dev, stream=4),
                          device=dev)
    layers = [(w[perm].contiguous(), b[perm].contiguous())
              for w, b in layers]
    recs = {r["name"]: gen.recording(r) for r in mix["recordings"]}
    names = list(recs)
    targets = dict(zip(names, gen.noise_traces(
        [len(recs[n][0]) for n in names], float(mix["target_sigma"]),
        cell.seed, dev)))
    spans = {n: tuple(mix.get("spans", {}).get(n, (0, len(recs[n][0]))))
             for n in names}
    return layers, gate, recs, targets, spans


class Run:
    def __init__(self, cell):
        from ionflux_torch import eval as E
        from ionflux_torch.models.nn import MLP, NNdParams, NNfParams
        from ionflux_torch.models.registry import Constants, HHParams

        self.cell, self.E = cell, E
        cfg = cell.config
        self.kind = cfg["kind"]
        self.layers, self.gate, self.recs, targets, self.spans = inputs(cell)
        self.names = list(self.recs)
        wrap = NNfParams if self.kind == "nnf" else NNdParams
        self.params = wrap(MLP(self.layers),
                           HHParams(*[np.float32(x) for x in self.gate]))
        self.c = Constants(np.float32(cfg["g"]), np.float32(cfg["e_mv"]))
        self.truth = {n: targets[n].cpu().numpy() for n in self.names}
        self.voltages = {n: (v.astype(np.float32), dt)
                         for n, (v, dt) in self.recs.items()}
        self.kw = dict(cell.mix["solver"])
        self.orders = gen.generator(cell.seed, cell.device, stream=6)
        self.scored = []        # (order, MAEs) of every call
        # warm-up: the eager chain and its capture, then one replay
        self._score()
        self._score()

    def _score(self) -> np.ndarray:
        p = self.layers[0][0].shape[0]
        order = torch.randperm(p, generator=self.orders,
                               device=self.cell.device)
        net = self.params.net
        pop = type(self.params)(type(net)(
            [(w[order], b[order]) for w, b in self.layers]), self.params[1])
        maes = self.E.population_rollout_maes(
            self.kind, pop, self.names, self.c, self.truth,
            spans=self.spans, voltages=self.voltages, **self.kw)
        self.scored.append((order, maes))
        return maes

    def call(self):
        maes = self._score()
        return maes.size, 1, int(not np.isfinite(maes).all())

    def trace_info(self) -> dict:
        """The shapes B1's work is counted on: layer sizes, members, lanes
        (members x recordings) and the knots of a segment on every lane;
        the accepted trips are the traced calls' own counts
        (benchmark/spans.py).  Logs the last call's counts by segment."""
        sizes = [int(self.layers[0][0].shape[1])] + [
            int(w.shape[2]) for w, _ in self.layers]
        p, q = self.layers[0][0].shape[0], len(self.names)
        seg = min(int(self.kw["seg_samples"]),
                  max(len(v) for v, _ in self.voltages.values()))
        rec = S.recorded()
        if rec is not None:
            last = max((s.id for s in rec[0] if s.name == "rollout"),
                       default=None)
            trips = [[c.value for c in rec[1] if c.root == last
                      and c.name == n]
                     for n in ("b1.trips_executed", "b1.trips_accepted")]
            self.cell.log(f"segments (executed, accepted trips) of the "
                          f"last call: {list(zip(*trips))}")
        return dict(sizes=sizes, kind=self.kind, members=p, lanes=p * q,
                    knots=(seg + 1) * q)

    def release(self) -> None:
        self.params = None
        self.E._ROLLOUT_GRAPHS.clear()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """(name, value, limit) of every number compared."""
        lim = self.cell.workload["limits"]
        scored = [(o.cpu().numpy(), m) for o, m in self.scored]
        self.release()
        sol = reference_solve(self.cell, self.kind, self.layers, self.gate,
                              self.recs)
        ref = reference_maes(self.cell, sol, self.recs, self.spans,
                             self.cell.seed)
        gaps = [mae_gap(m, ref[o]) for o, m in scored]
        self.cell.log(f"mae_gap of each of {len(gaps)} calls: {gaps}")
        return [("mae_gap", max(gaps), float(lim["mae_gap"]))]


def _recordings(cell, recs):
    dev = cell.device
    names = list(recs)
    vs = [torch.as_tensor(recs[n][0].astype(np.float32), device=dev)
          for n in names]
    dts = {recs[n][1] for n in names}
    if len(dts) != 1:
        raise ValueError(f"recordings at several sample rates: {dts}")
    return names, vs, dts.pop()


def reference_solve(cell, kind, layers, gate, recs, *, dtype=torch.float64,
                    tf32=False, tol=None) -> dict:
    """The plain reference's solve of every lane, at the mix's reference
    tolerances unless ``tol`` (a dict of rtol, atol) is given."""
    _, vs, dt = _recordings(cell, recs)
    tol = tol or cell.mix["reference"]
    sol = RV.solve(kind, layers, gate, vs, dt, rtol=float(tol["rtol"]),
                   atol=float(tol["atol"]), dtype=dtype, tf32=tf32)
    cell.log(f"reference: {sol['steps'].iterations} iterations, at most "
             f"{sol['steps'].rejected} rejected in a lane ({dtype}, "
             f"tf32={tf32}, rtol {tol['rtol']}, atol {tol['atol']})")
    return sol


def reference_maes(cell, sol, recs, spans, seed) -> np.ndarray:
    """A reference solve's MAEs [P, Q] against the seed's targets."""
    names, _, _ = _recordings(cell, recs)
    targets = gen.noise_traces([len(recs[n][0]) for n in names],
                               float(cell.mix["target_sigma"]), seed,
                               cell.device)
    return RV.score(sol, targets, [spans[n] for n in names],
                    float(cell.config["g"]),
                    float(np.float32(cell.config["e_mv"]))).cpu().numpy()


def mae_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The widest relative gap of a lane's MAE from the reference's (inf
    where the program's lane is not finite)."""
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def setup(cell) -> Run:
    return Run(cell)


def control(cell, seeds) -> dict:
    """The control on each seed: the reference itself put in the program's
    place, at the program's tolerances, in the precision below the
    configuration's (float32 states, TF32 products), judged by the same
    number against the float64 reference; beside it the same in full
    float32, which the limit has to pass.  A seed only orders the members
    and draws the targets, so each side solves once and is scored against
    every seed's targets."""
    layers, gate, recs, _, spans = inputs(cell)
    kind, tol = cell.config["kind"], cell.mix["solver"]
    sols = {"ref": reference_solve(cell, kind, layers, gate, recs)}
    for name, tf32 in (("tf32", True), ("f32", False)):
        sols[name] = reference_solve(cell, kind, layers, gate, recs,
                                     dtype=torch.float32, tf32=tf32, tol=tol)
    out = {}
    for seed in seeds:
        maes = {k: reference_maes(cell, sol, recs, spans, seed)
                for k, sol in sols.items()}
        out[seed] = {k: mae_gap(maes[k], maes["ref"]) for k in ("tf32",
                                                                "f32")}
    return out
