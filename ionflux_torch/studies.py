"""Synthetic studies and the checkpoint-validated training recipe
(counterpart of ``ionflux/studies.py``, its surface-training main path):

  s1: NN-f on HH ground truth;   s2: NN-d on HH ground truth;
  d1: NN-f on 3-state Markov ground truth;
  d2: NN-d on Markov ground truth (smoothing window 151, spline s = 1,
      sparse 21).

``run_study_validated`` trains across init seeds in ``val_every``-update
chunks, scores every checkpoint by its rollout MAEs on the five table-1
recordings against the study's noisy data, and keeps the best (seed,
iteration).  On a CUDA device it scores all checkpoints at once through the
chained popsweep kernel (``table_rollout_maes_pop`` ->
``eval.population_rollout_maes``); a failure there raises, where the
reference falls back to the per-checkpoint path.

Everything runs on ``device`` (the card unless the caller asks for the
CPU) or on the device of the tensors given.  The runners that read the
reference's ``ap2hz.csv`` (``run_study``, ``predict_study``,
``s_rollout_maes``, ``run_study_best_of``) are not ported.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch import protorec
from ionflux_torch._device import resolve_device
from ionflux_torch.data import synth_study_currents
from ionflux_torch.eval import population_rollout_maes, solve_states_real
from ionflux_torch.fit.train import (boundary_anchors, fit_chunk,
                                     init_opt_state, pretrain, surface_loss)
from ionflux_torch.models import a_gate_rhs, nnd_init, nnf_init
from ionflux_torch.models.nn import MLP, NNdParams, NNfParams
from ionflux_torch.models.registry import (
    HH_B06,
    HH_D0_INIT,
    HH_D2_BASE,
    HH_D_PRETRAIN,
    MARKOV_B06,
    SYNTHETIC,
    TABLE1,
    HHParams,
)
from ionflux_torch.observe import add_noise, gate_current, markov_current
from ionflux_torch.surface import (SurfaceConfig, concat_surfaces,
                                   estimate_gate_surface)
from ionflux_torch.utils.ckpt import (load_pytree, save_model_bundle,
                                      save_pytree)

# The reference checkout (its table-1/yc-*.pt noisy traces), where one is
# present: named by IONFLUX_REFERENCE; without it the noisy targets are drawn
REFDIR = os.environ.get("IONFLUX_REFERENCE")

T1 = np.linspace(0.0, 8000.0, 80001)
T2 = np.linspace(0.0, 10000.0, 100001)
PRED_T = np.linspace(0.0, 3000.0, 1501)


@dataclass(frozen=True)
class SyntheticStudy:
    name: str
    gt_kind: str                  # 'hh' | 'markov'
    gt: tuple                     # ground-truth params
    rgate: HHParams               # known r-gate (p5-p8 used)
    model_kind: str               # 'nnf' | 'nnd'
    base_hh: HHParams | None      # NN-d analytic part
    init_std: float
    pretrain_hh: HHParams | None  # None = no pretrain stage
    cfg: SurfaceConfig
    iters: int = 4000             # main loop length
    step_size: int = 100          # staircase decay period
    init_seed: int = 0            # seed of the MLP init
    anchor_weight: float = 0.0    # boundary-anchor regulariser (off = parity)
    pretrain_iters: int = 1000    # pretrain stage length


S1 = SyntheticStudy("s1", "hh", HH_B06, HH_B06, "nnf", None, 0.1,
                    HH_B06, SurfaceConfig())
S2 = SyntheticStudy("s2", "hh", HH_B06, HH_B06, "nnd", HH_B06, 1e-3,
                    None, SurfaceConfig())
D1 = SyntheticStudy("d1", "markov", MARKOV_B06, HH_D0_INIT, "nnf", None, 0.1,
                    HH_D_PRETRAIN, SurfaceConfig(), iters=8000, step_size=400)
D2 = SyntheticStudy("d2", "markov", MARKOV_B06, HH_D0_INIT, "nnd", HH_D2_BASE,
                    1e-3, None,
                    SurfaceConfig(sparse=21, smooth_window=151, spline_s=1.0),
                    iters=8000, step_size=400, init_seed=0)
D2_PARITY = SyntheticStudy(
    "d2", "markov", MARKOV_B06, HH_D0_INIT, "nnd", HH_D2_BASE, 1e-3, None,
    SurfaceConfig(sparse=21, smooth_window=151, spline_s=1.0),
    iters=8000, step_size=400, init_seed=20)

STUDIES = {s.name: s for s in (S1, S2, D1, D2)}


def study_surface(spec: SyntheticStudy, outdir: str, cached: bool = False,
                  device=None):
    """Noisy data and the derivative surface (v, a, dadt), numpy f64,
    cached as ``surface.npz`` in outdir.  The 16 ground-truth and 16 r-gate
    solves run on ``device``; the splines on the host."""
    cache = os.path.join(outdir, "surface.npz")
    if cached and os.path.exists(cache):
        with np.load(cache) as d:
            return d["v"], d["a"], d["dadt"]
    device = resolve_device(device)
    t1 = torch.as_tensor(T1, dtype=torch.float32, device=device)
    t2 = torch.as_tensor(T2, dtype=torch.float32, device=device)
    act, deact = synth_study_currents(spec.gt, t1, t2)
    mask1, mask2 = P.s_study_masks()
    parts = [
        estimate_gate_surface(pr, t1, act[k], spec.rgate, SYNTHETIC, mask1,
                              spec.cfg)
        for k, pr in enumerate(P.activation_family(device=device))
    ] + [
        estimate_gate_surface(pr, t2, deact[k], spec.rgate, SYNTHETIC, mask2,
                              spec.cfg)
        for k, pr in enumerate(P.deactivation_family(device=device))
    ]
    v, a, dadt = concat_surfaces(parts)
    os.makedirs(outdir, exist_ok=True)
    np.savez(cache, v=v, a=a, dadt=dadt)
    return v, a, dadt


def init_params(spec: SyntheticStudy, generator=None, device=None):
    """The study's initial model; the MLP drawn from ``generator`` (a
    ``torch.Generator`` seeded ``spec.init_seed`` by default)."""
    if generator is None:
        generator = torch.Generator().manual_seed(spec.init_seed)
    if spec.model_kind == "nnf":
        return nnf_init(generator, spec.rgate, std=spec.init_std,
                        device=device)
    return nnd_init(generator, spec.base_hh, std=spec.init_std,
                    device=device)


def wrap_net(spec: SyntheticStudy, net):
    net = net if isinstance(net, MLP) else MLP(net)
    if spec.model_kind == "nnf":
        return NNfParams(net=net, rgate=spec.rgate)
    return NNdParams(net=net, hh=spec.base_hh)


def load_study_params(spec: SyntheticStudy, outdir: str, device=None):
    return load_pytree(os.path.join(outdir, "model.npz"), spec.model_kind,
                       device)


def _net_device(params) -> torch.device:
    return params.net.layers[0][0].device


# Ground-truth and noisy target traces by _gt_key
_GT_ROLLOUTS: dict = {}


def _gt_key(spec, *rest):
    """Cache key of a ground-truth rollout: the gt parameter VALUES and the
    kind, so two specs of one kind with other parameters never share
    targets."""
    digest = tuple(float(x) for x in
                   np.concatenate([np.asarray(lf, np.float64).reshape(-1)
                                   for lf in spec.gt]))
    return (spec.gt_kind, digest) + rest


def _sim_real_table(kind: str, params, name: str, device=None) -> np.ndarray:
    """Current (numpy f64) on a recorded table-1 protocol, TABLE1
    constants."""
    ys = solve_states_real(kind, params, name, device=device)
    v, _dt = protorec.load_voltage(name)
    cur = markov_current if kind == "markov" else gate_current
    vq = torch.as_tensor(v, device=ys.device).to(torch.float32)
    return cur(ys, vq, TABLE1).double().cpu().numpy()


_TABLE_COLS = [("pr3", "pr3-cell5", None), ("pr5", "pr5-cell5", None),
               ("pr4", "pr4-cell5", None),
               ("sin", "sinewave-cell5", "yc-sinewave.pt"),
               ("aps", "aps-cell5", "yc-aps.pt")]


def _table_targets(spec: SyntheticStudy, noisy: bool, device=None) -> list:
    """Fill _GT_ROLLOUTS with the five table-1 columns' targets and return
    the column list.  noisy=True: the ground truth plus 0.1 N(0, 1) noise
    from a ``torch.Generator`` seeded with the column's index (the
    reference's stored ``yc-*.pt`` traces where ``REFDIR`` has them);
    noisy=False: the clean ground truth."""
    dev = None
    for i, (_label, n, yc) in enumerate(_TABLE_COLS):
        key = _gt_key(spec, n, noisy)
        if key in _GT_ROLLOUTS:
            continue
        dev = dev or resolve_device(device)
        path = os.path.join(REFDIR or "", "table-1", yc or "")
        if noisy and REFDIR and yc is not None and os.path.exists(path):
            trace = torch.load(path, map_location="cpu", weights_only=False)
            _GT_ROLLOUTS[key] = np.asarray(trace, np.float64).reshape(-1)
            continue
        gt = _sim_real_table(spec.gt_kind, spec.gt, n, device=dev)
        if noisy:
            gen = torch.Generator(device=dev).manual_seed(i)
            gt = add_noise(gen, torch.as_tensor(gt, device=dev)).cpu().numpy()
        _GT_ROLLOUTS[key] = gt
    return _TABLE_COLS


def _pr4_span() -> slice:
    n4 = protorec.PR4_N // 16
    return slice(n4, 4 * n4)


def table_rollout_maes(spec: SyntheticStudy, params,
                       noisy: bool = True) -> dict:
    """Rollout MAEs on the five table-1 recordings (Pr4 scored on sweeps
    1-3) against the study's noisy data (noisy=True) or the clean ground
    truth, by the plain chained solve on the device of params' net.
    Returns {'pr3', 'pr5', 'pr4', 'sin', 'aps', 'score'}; a non-finite
    rollout scores inf."""
    dev = _net_device(params)
    cols = _table_targets(spec, noisy, dev)
    out = {}
    for label, n, _yc in cols:
        pred = _sim_real_table(spec.model_kind, params, n, device=dev)
        data = _GT_ROLLOUTS[_gt_key(spec, n, noisy)]
        sl = _pr4_span() if label == "pr4" else slice(None)
        out[label] = float(np.mean(np.abs(pred[sl] - data[sl])))
    score = sum(out.values())
    out["score"] = score if np.isfinite(score) else float("inf")
    return out


def table_rollout_maes_pop(spec: SyntheticStudy, params_list,
                           noisy: bool = True, batch: int = 64,
                           trips: int = 8192,
                           rescore_inf: bool = True) -> list[dict]:
    """``table_rollout_maes`` for many checkpoints at once: batches of
    ``batch`` members (the last padded by repeating its last checkpoint)
    through ``eval.population_rollout_maes`` (the chained popsweep kernel on
    the card), rtol 1e-6 / atol 1e-8, Pr4 scored on sweeps 1-3.

    rescore_inf scores a row that came back non-finite again through
    ``table_rollout_maes``: a lane the kernel culled, or that ran out of
    the shared trip budget, may finish on its own.  The rows rescored and
    their seconds are printed on one line."""
    dev = _net_device(params_list[0])
    cols = _table_targets(spec, noisy, dev)
    names = [n for _, n, _ in cols]
    sl4 = _pr4_span()
    n_req = len(params_list)
    if n_req % batch:
        params_list = params_list + [params_list[-1]] * (
            batch - n_req % batch)
    stacked = [(torch.stack([p.net.layers[i][0] for p in params_list]),
                torch.stack([p.net.layers[i][1] for p in params_list]))
               for i in range(len(params_list[0].net.layers))]
    maes = np.empty((len(params_list), len(cols)))
    truth = {n: _GT_ROLLOUTS[_gt_key(spec, n, noisy)] for n in names}
    spans = {n: (sl4.start, sl4.stop)
             for label, n, _ in cols if label == "pr4"}
    for i0 in range(0, len(params_list), batch):
        sub = type(params_list[0])(
            MLP([(w[i0:i0 + batch], b[i0:i0 + batch]) for w, b in stacked]),
            params_list[0][1])
        maes[i0:i0 + batch] = population_rollout_maes(
            spec.model_kind, sub, names, TABLE1, truth, spans=spans,
            rtol=1e-6, atol=1e-8, trips=trips)
    out = []
    n_rescored, secs = 0, 0.0
    for k, row in enumerate(maes[:n_req]):
        d = {label: float(row[j])
             for j, (label, _n, _yc) in enumerate(cols)}
        s = float(row.sum())
        if not np.isfinite(s) and rescore_inf:
            t = time.perf_counter()
            d = table_rollout_maes(spec, params_list[k], noisy)
            secs += time.perf_counter() - t
            n_rescored += 1
        else:
            d["score"] = s if np.isfinite(s) else float("inf")
        out.append(d)
    print(f"table_rollout_maes_pop: {n_req} checkpoints at {trips} trips; "
          f"{n_rescored} non-finite rows rescored singly in {secs:.3f} s")
    return out


def run_study_validated(spec: SyntheticStudy, outdir: str, n_seeds: int = 6,
                        iters: int | None = None, cached: bool = False,
                        val_every: int = 400, debug: bool = False,
                        metric=None, target_net=None,
                        batch_validate: bool | None = None, device=None):
    """Train across init seeds in ``val_every``-update chunks, score every
    checkpoint with ``metric`` (``table_rollout_maes`` by default) and keep
    the globally best (seed, iteration); write model.npz and
    model-entire.npz to outdir and return the kept params.

    batch_validate (default: on for NN-f / NN-d with the default metric on
    a CUDA device) defers the scoring and runs all checkpoints through
    ``table_rollout_maes_pop`` after training.  Unlike the reference, a
    failure there raises instead of falling back to per-checkpoint
    scoring.  ``debug`` (the surface plot) needs ``figures.py``, which is
    not ported."""
    if debug:
        raise NotImplementedError(
            "run_study_validated(debug=True) draws the surface plot of "
            "figures.py, which is not ported (ROADMAP A12)")
    device = resolve_device(device)
    v, a, dadt = study_surface(spec, outdir, cached, device)
    keep = (a > 0) & (a < 1)
    x = torch.as_tensor(np.stack([v[keep] / 100.0, a[keep]], axis=-1),
                        dtype=torch.float32, device=device)
    y = torch.as_tensor(dadt[keep], dtype=torch.float32, device=device)
    residual = None
    if spec.model_kind == "nnd":
        residual = a_gate_rhs(spec.base_hh, x[:, 1], x[:, 0] * 100.0)
    anchors = (boundary_anchors(
        None if spec.model_kind == "nnd" else (spec.pretrain_hh or spec.rgate),
        weight=spec.anchor_weight, device=device)
        if spec.anchor_weight > 0 else None)
    if metric is None:
        metric = table_rollout_maes
    if target_net is not None:
        print("Target Loss", float(surface_loss(target_net, x, y)))
    if batch_validate is None:
        batch_validate = (metric is table_rollout_maes
                          and spec.model_kind in ("nnf", "nnd")
                          and device.type == "cuda")
    elif batch_validate and metric is not table_rollout_maes:
        raise ValueError("batch_validate=True requires the default "
                         "table_rollout_maes metric")

    total = iters if iters is not None else spec.iters
    best = (float("inf"), None, -1, -1)
    collected = []
    for seed in range(n_seeds):
        sspec = replace(spec, init_seed=seed)
        net = init_params(sspec, device=device).net
        if sspec.pretrain_hh is not None:
            net = pretrain(net, sspec.pretrain_hh, kind="s",
                           iters=sspec.pretrain_iters).params
        opt_state = init_opt_state(net, 1e-3, sspec.step_size, 0.9)
        done = 0
        while done < total:
            n = min(val_every, total - done)
            net, opt_state, losses = fit_chunk(
                net, opt_state, x, y, residual, anchors, iters=n, lr=1e-3,
                step_size=sspec.step_size, gamma=0.9)
            done += n
            if batch_validate:
                collected.append((seed, done, wrap_net(sspec, net)))
                print(f"seed {seed} iter {done:5d} | train "
                      f"{float(losses[-1]):.5f} | rollout deferred")
                continue
            m = metric(sspec, wrap_net(sspec, net))
            print(f"seed {seed} iter {done:5d} | train "
                  f"{float(losses[-1]):.5f} | " +
                  " ".join(f"{k} {v_:.3f}" for k, v_ in m.items()
                           if k != "score"))
            if m["score"] < best[0]:
                best = (m["score"], wrap_net(sspec, net), seed, done)
    if batch_validate and collected:
        res = table_rollout_maes_pop(spec, [p for _, _, p in collected])
        for (seed, it, p), m in zip(collected, res):
            print(f"seed {seed} iter {it:5d} | " +
                  " ".join(f"{k} {v_:.3f}" for k, v_ in m.items()
                           if k != "score"))
            if m["score"] < best[0]:
                best = (m["score"], p, seed, it)
    score, params, seed, it = best
    if params is None:
        raise RuntimeError(
            f"run_study_validated({spec.name}): no checkpoint produced a "
            f"finite five-protocol rollout across {n_seeds} seeds")
    print(f"kept validation-best model: seed {seed} iter {it} "
          f"(score {score:.3f})")
    save_pytree(os.path.join(outdir, "model.npz"), params)
    save_model_bundle(os.path.join(outdir, "model-entire.npz"), params, spec)
    return params
