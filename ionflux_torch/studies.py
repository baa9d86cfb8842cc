"""Synthetic studies, their training recipes and the prediction replay
(counterpart of ``ionflux/studies.py``):

  s1: NN-f on HH ground truth;   s2: NN-d on HH ground truth;
  d1: NN-f on 3-state Markov ground truth;
  d2: NN-d on Markov ground truth (smoothing window 151, spline s = 1,
      sparse 21).

``run_study`` trains one seed (pretrain, then the surface fit) and ends
with the AP2Hz line; ``run_study_best_of`` keeps the best of several seeds
by their whole-trace rollouts.  ``run_study_validated`` trains across init
seeds in ``val_every``-update chunks, scores every checkpoint with a metric
(the five table-1 recordings against the study's noisy data by default;
``s_rollout_maes`` for the s-studies) and keeps the best (seed, iteration).
On a CUDA device it scores the default metric's checkpoints all at once
through the chained popsweep kernel (``table_rollout_maes_pop`` ->
``eval.population_rollout_maes``); a failure there raises, where the
reference falls back to the per-checkpoint path.  ``predict_study`` is the
drivers' ``--pred`` replay over ``prediction_cases``.

Everything runs on ``device`` (the card unless the caller asks for the
CPU) or on the device of the tensors given.  The AP2Hz protocol and the
other ``test-protocols/*.csv`` files are read from the reference checkout
named by ``IONFLUX_REFERENCE`` (``REFDIR``: set from it when the module
is imported, read when a function runs); without ``ap2hz.csv`` the
functions that need it raise.
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
from ionflux_torch.eval import (population_rollout_maes, report_mae,
                                simulate, simulate_cases, solve_states_real)
from ionflux_torch.fit.train import (boundary_anchors, fit_chunk,
                                     fit_surface, init_opt_state, pretrain,
                                     surface_loss)
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

# The reference checkout, where one is present, named by IONFLUX_REFERENCE:
# its test-protocols/*.csv and table-1/yc-*.pt noisy traces.  Functions
# read this global when they run; without it the noisy targets are drawn
# and the AP2Hz pieces raise.
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


def _ap2hz(device) -> P.Protocol:
    """The reference's AP2Hz protocol, ``REFDIR/test-protocols/ap2hz.csv``
    (time in s, voltage in mV)."""
    path = os.path.join(REFDIR or "", "test-protocols", "ap2hz.csv")
    if not REFDIR or not os.path.exists(path):
        raise FileNotFoundError(
            "test-protocols/ap2hz.csv is needed: set IONFLUX_REFERENCE to "
            f"a reference checkout that holds it (IONFLUX_REFERENCE={REFDIR!r})")
    return P.load_csv(path, device=device)


def _surface_xy(spec: SyntheticStudy, v, a, dadt, device):
    """The training points (0 < a < 1) as x = (V / 100, a), y = da/dt, and
    NN-d's residual (the analytic a-gate), on device."""
    keep = (a > 0) & (a < 1)
    x = torch.as_tensor(np.stack([v[keep] / 100.0, a[keep]], axis=-1),
                        dtype=torch.float32, device=device)
    y = torch.as_tensor(dadt[keep], dtype=torch.float32, device=device)
    residual = None
    if spec.model_kind == "nnd":
        residual = a_gate_rhs(spec.base_hh, x[:, 1], x[:, 0] * 100.0)
    return x, y, residual


def _anchors(spec: SyntheticStudy, device):
    if spec.anchor_weight <= 0.0:
        return None
    # NN-d nets anchor their residual to 0 (fall back to the analytic part);
    # NN-f nets to the pretrain / analytic a-gate surface
    return boundary_anchors(
        None if spec.model_kind == "nnd" else (spec.pretrain_hh or spec.rgate),
        weight=spec.anchor_weight, device=device)


def _rates3d(spec: SyntheticStudy, outdir: str, v, a, dadt, net) -> None:
    """The reference's --debug plot: the (V, a, da/dt) surface with the
    learned one, ``rates3d-000.png``."""
    from ionflux_torch.figures import surface_scatter_3d

    surface_scatter_3d(
        os.path.join(outdir, "rates3d-000.png"), v, a, dadt, net=net,
        nnd_base=spec.base_hh if spec.model_kind == "nnd" else None)
    print(f"wrote {outdir}/rates3d-000.png")


def run_study(spec: SyntheticStudy, outdir: str, iters: int | None = None,
              cached: bool = False, target_net=None, debug: bool = False,
              device=None):
    """One seed's training: the surface, the pretrain stage (where the spec
    has one), Adam on the surface (NN-d on the residual), model.npz and
    model-entire.npz, then the AP2Hz line against the ground truth.
    target_net: an s1-trained net whose loss on this surface is printed as
    "Target Loss".  Returns the trained params."""
    device = resolve_device(device)
    v, a, dadt = study_surface(spec, outdir, cached, device)
    x, y, residual = _surface_xy(spec, v, a, dadt, device)
    net = init_params(spec, device=device).net
    if spec.pretrain_hh is not None:
        res = pretrain(net, spec.pretrain_hh, kind="s",
                       iters=spec.pretrain_iters)
        net = res.params
        print(f"pretrain done | final loss {float(res.losses[-1]):.6f}")
    if target_net is not None:
        print("Target Loss", float(surface_loss(target_net, x, y)))
    n_iters = iters if iters is not None else spec.iters
    res = fit_surface(net, x, y, residual, _anchors(spec, device),
                      iters=n_iters, lr=1e-3, step_size=spec.step_size,
                      gamma=0.9)
    net = res.params
    print(f"train done | iters {n_iters} | "
          f"final loss {float(res.losses[-1]):.6f}")
    params = wrap_net(spec, net)
    save_pytree(os.path.join(outdir, "model.npz"), params)
    save_model_bundle(os.path.join(outdir, "model-entire.npz"), params, spec)
    if debug:
        _rates3d(spec, outdir, v, a, dadt, net)
    ap2hz = _ap2hz(device)
    ts = torch.as_tensor(PRED_T, dtype=torch.float32, device=device)
    truth = simulate(spec.gt_kind, spec.gt, ap2hz, ts, SYNTHETIC)
    pred = simulate(spec.model_kind, params, ap2hz, ts, SYNTHETIC)
    report_mae("Pretraining", pred, truth)
    return params


def prediction_cases(device=None) -> list:
    """Every --pred protocol as (label, header, proto, ts) rows: AP2Hz, the
    APs, sinewave and staircase protocols (``REFDIR/test-protocols/*.csv``,
    else the recorded APs and sinewave waveforms and the parametric
    staircase), then the activation, deactivation and activation-time-
    constant families at 1 ms knots."""
    device = resolve_device(device)

    def grid(ts):
        return torch.as_tensor(ts, dtype=torch.float32, device=device)

    rows = [("AP 2Hz prediction", None, _ap2hz(device), grid(PRED_T))]
    for name, fname, ts in [
        ("APs prediction", "aps.csv", np.linspace(0.0, 8000.0, 4001)),
        ("Sinewave prediction", "sinewave.csv",
         np.linspace(0.0, 8000.0, 4001)),
        ("Staircase prediction", "staircase.csv",
         np.linspace(0.0, 15000.0, 7501)),
    ]:
        path = os.path.join(REFDIR or "", "test-protocols", fname)
        if REFDIR and os.path.exists(path):
            rows.append((name, None, P.load_csv(path, device=device),
                         grid(ts)))
        elif fname == "sinewave.csv":
            rows.append((name, None,
                         protorec.protocol("sinewave-cell5", device=device),
                         grid(ts)))
        elif fname == "aps.csv":
            rows.append((f"{name} (ap-cell-5 waveform)", None,
                         protorec.protocol("aps-cell5", device=device),
                         grid(ts)))
        else:
            rows.append((name, None, P.staircase_protocol(device=device),
                         grid(ts)))
    fams = [
        ("Activation prediction:", P.activation_family(1.0, device),
         np.linspace(0.0, 8000.0, 8001),
         [f"{v:.1f}mV" for v in P.ACTIVATION_STEPS_MV]),
        ("Deactivation prediction:", P.deactivation_family(1.0, device),
         np.linspace(0.0, 10000.0, 10001),
         [f"{v:.1f}mV" for v in P.DEACTIVATION_STEPS_MV]),
        ("Activation time constant at 40mV prediction:",
         P.atau_family(1.0, device), np.linspace(0.0, 5000.0, 5001),
         [f"{d:.1f}ms" for d in P.ATAU_DURATIONS_MS]),
    ]
    for header, protos, ts, labels in fams:
        for k, (pr, lab) in enumerate(zip(protos, labels)):
            rows.append((f"    {lab}", header if k == 0 else None, pr,
                         grid(ts)))
    return rows


# the prediction solves' budget: the 15 s staircase's accepted steps
# exceed the default 4,096 dense-output records
_PRED_KW = dict(max_steps=400_000, buffer_size=16384)


def predict_study(spec: SyntheticStudy, params, device=None) -> dict:
    """--pred replay: each prediction case's MAE against the ground truth
    (printed as the reference's loss lines), {label: MAE}; on the device of
    params' net unless ``device`` is given."""
    dev = torch.device(device) if device is not None else _net_device(params)
    rows = prediction_cases(dev)
    cases = [(proto, ts) for _, _, proto, ts in rows]
    truths = simulate_cases(spec.gt_kind, spec.gt, cases, SYNTHETIC,
                            **_PRED_KW)
    preds = simulate_cases(spec.model_kind, params, cases, SYNTHETIC,
                           **_PRED_KW)
    out = {}
    for (label, header, _, _), t_, p_ in zip(rows, truths, preds):
        if header:
            print(header)
        out[label.strip()] = report_mae(label, p_, t_)
    return out


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


def s_rollout_maes(spec: SyntheticStudy, params) -> dict:
    """Clean-ground-truth rollout MAEs on the s-study prediction protocols
    (the rows of s1/log2, s2/log2): AP2Hz, sinewave, staircase and the
    activation / deactivation family means, on the device of params' net.
    A non-finite score makes every entry inf."""
    dev = _net_device(params)

    def grid(t_end, n):
        return torch.linspace(0.0, t_end, n, dtype=torch.float32, device=dev)

    rows = [("ap2hz", _ap2hz(dev),
             torch.as_tensor(PRED_T, dtype=torch.float32, device=dev)),
            ("sin", protorec.protocol("sinewave-cell5", device=dev),
             grid(8000.0, 4001)),
            ("stair", P.staircase_protocol(device=dev), grid(15000.0, 7501))]
    out = {}
    for label, proto, ts in rows:
        key = _gt_key(spec, label, "s")
        if key not in _GT_ROLLOUTS:
            _GT_ROLLOUTS[key] = simulate(
                spec.gt_kind, spec.gt, proto, ts, SYNTHETIC,
                **_PRED_KW).double().cpu().numpy()
        pred = simulate(spec.model_kind, params, proto, ts, SYNTHETIC,
                        **_PRED_KW).double().cpu().numpy()
        out[label] = float(np.mean(np.abs(pred - _GT_ROLLOUTS[key])))
    fams = [("act", P.activation_family(1.0, dev), grid(8000.0, 2001)),
            ("deact", P.deactivation_family(1.0, dev), grid(10000.0, 2001))]
    for label, protos, ts in fams:
        maes = []
        for k, pr in enumerate(protos):
            key = _gt_key(spec, label, k, "s")
            if key not in _GT_ROLLOUTS:
                _GT_ROLLOUTS[key] = simulate(
                    spec.gt_kind, spec.gt, pr, ts,
                    SYNTHETIC).double().cpu().numpy()
            pred = simulate(spec.model_kind, params, pr, ts,
                            SYNTHETIC).double().cpu().numpy()
            maes.append(float(np.mean(np.abs(pred - _GT_ROLLOUTS[key]))))
        out[label] = float(np.mean(maes))
    score = sum(out.values())
    out["score"] = score if np.isfinite(score) else float("inf")
    if not np.isfinite(score):
        out = {k: float("inf") for k in out}
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
    scoring.  ``debug`` draws the surface with the kept net
    (``rates3d-000.png``, matplotlib)."""
    device = resolve_device(device)
    v, a, dadt = study_surface(spec, outdir, cached, device)
    x, y, residual = _surface_xy(spec, v, a, dadt, device)
    anchors = _anchors(spec, device)
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
    if debug:
        _rates3d(spec, outdir, v, a, dadt, params.net)
    return params


def run_study_best_of(spec: SyntheticStudy, outdir: str, n_seeds: int = 4,
                      iters: int | None = None, cached: bool = False,
                      debug: bool = False, device=None):
    """``run_study`` for each of n_seeds init seeds; keeps the model with
    the least mean whole-trace rollout MAE against the ground truth on
    AP2Hz and the activation / deactivation families (a non-finite
    rollout scores inf), and writes it to outdir."""
    device = resolve_device(device)
    protos = ([_ap2hz(device)] + P.activation_family(device=device)
              + P.deactivation_family(device=device))

    def grid(t_end, n):
        return torch.linspace(0.0, t_end, n, dtype=torch.float32,
                              device=device)

    ts_list = ([grid(3000.0, 1501)] + [grid(8000.0, 2001)] * 7
               + [grid(10000.0, 2001)] * 9)
    best = (float("inf"), None)
    for seed in range(n_seeds):
        params = run_study(replace(spec, init_seed=seed), outdir,
                           iters=iters, cached=True if seed else cached,
                           debug=debug and seed == 0, device=device)
        maes = []
        ok = True
        for proto, ts in zip(protos, ts_list):
            truth = simulate(spec.gt_kind, spec.gt, proto, ts, SYNTHETIC)
            pred = simulate(spec.model_kind, params, proto, ts, SYNTHETIC)
            if not bool(torch.all(torch.isfinite(pred))):
                ok = False
                break
            maes.append(float(torch.mean(torch.abs(pred - truth))))
        score = float(np.mean(maes)) if ok else float("inf")
        print(f"seed {seed}: validation rollout MAE {score:.4f}")
        if score < best[0]:
            best = (score, params)
    if best[1] is None:
        raise RuntimeError(
            f"run_study_best_of({spec.name}): no seed produced a finite "
            f"whole-trace rollout across {n_seeds} seeds; refusing to save "
            "an unusable model (try anchor_weight > 0 or more seeds)")
    params = best[1]
    save_pytree(os.path.join(outdir, "model.npz"), params)
    save_model_bundle(os.path.join(outdir, "model-entire.npz"), params, spec)
    print(f"kept validation-best model (rollout MAE {best[0]:.4f})")
    return params
