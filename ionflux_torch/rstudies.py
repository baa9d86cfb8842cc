"""Real-data (Beattie 2018 cell-5) study definitions and runner (counterpart
of ``ionflux/rstudies.py``):

  r1      NN-f on Pr3+Pr5 surfaces               (train-r1.py)
  r2      NN-d, cell-5 HH base, no E shift       (train-r2.py)
  r1-bad  NN-f on insufficient protocols          (train-r1-bad.py)
  r1-tune NN-f with swept (n_layers, n_nodes)     (train-r1-tune.py)

Without the raw cell-5 CSVs (``<repo>/data``) the runner trains on the
reference's cached derivative surfaces (``REFDIR/<study>/{t,v,a,dadt}.pt``)
and scores each 400-update checkpoint by the chained whole-trace solve on
Pr5 against the measured current recovered from ``REFDIR/r1``
(``RealValidator``).  ``REFDIR`` is ``studies.REFDIR`` (from
``IONFLUX_REFERENCE``), read when a function runs.

One stated difference from the reference: ``run_real_study`` falls back to
rollout-health selection only when the reference files are absent
(``FileNotFoundError``, ``ReferenceMissing`` among them); any other fault
while the validator is built (a failed solve, a CUDA error) raises, where
the reference catches every exception.

Everything runs on ``device`` (the card unless the caller asks for the
CPU) or on the device of the parameters given.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch import protorec
from ionflux_torch import studies
from ionflux_torch._device import resolve_device
from ionflux_torch.eval import simulate, simulate_long, solve_states_real
from ionflux_torch.fit.train import (fit_chunk, fit_surface, init_opt_state,
                                     pretrain_grid_r)
from ionflux_torch.models import a_gate_rhs, nnd_init, nnf_init
from ionflux_torch.models.nn import MLP, NNdParams, NNfParams
from ionflux_torch.models.registry import (
    ARCHITECTURES,
    CELL5_R1,
    CELL5_R1BAD,
    CELL5_R2,
    Constants,
    HH_CELL5_FIT,
    HH_CELL5_INIT,
    HH_R1BAD_INIT,
    HHParams,
)
from ionflux_torch.observe import gate_current
from ionflux_torch.realdata import _pt_load, recover_measurements
from ionflux_torch.utils.ckpt import (load_pytree, save_checkpoint,
                                      save_model_bundle, save_pytree)


class ReferenceMissing(FileNotFoundError):
    """IONFLUX_REFERENCE names no reference checkout."""


def refdir() -> str:
    """The reference checkout (``studies.REFDIR``); raises
    ``ReferenceMissing`` when none is named."""
    if not studies.REFDIR:
        raise ReferenceMissing(
            "the r-studies read the reference's surface caches: set "
            "IONFLUX_REFERENCE to a checkout holding r1/, r2/, r1-bad/")
    return studies.REFDIR


@dataclass(frozen=True)
class RealStudy:
    name: str
    model_kind: str               # 'nnf' | 'nnd'
    rgate: HHParams               # known r-gate (p5-p8)
    base_hh: HHParams | None      # NN-d analytic part
    constants: Constants
    init_std: float
    pretrain_hh: HHParams         # analytic pretrain surface (p1-p4)
    pretrain_residual: bool       # NN-d pretrains through its analytic part
    surface_dir: str              # reference dir with cached {t,v,a,dadt}.pt
    n_layers: int = 5
    n_nodes: int = 200
    iters: int = 16000
    step_size: int = 400


R1 = RealStudy("r1", "nnf", HH_CELL5_INIT, None, CELL5_R1, 0.1,
               HH_CELL5_INIT, False, "r1")
R2 = RealStudy("r2", "nnd", HH_CELL5_FIT, HH_CELL5_FIT, CELL5_R2, 1e-3,
               HH_CELL5_FIT, True, "r2")
R1BAD = RealStudy("r1-bad", "nnf", HH_R1BAD_INIT, None, CELL5_R1BAD, 0.1,
                  HH_R1BAD_INIT, False, "r1-bad")

RSTUDIES = {s.name: s for s in (R1, R2, R1BAD)}


def tune_study(arch_id: str) -> RealStudy:
    """r1-tune variant: architecture from --info sNN (train-r1-tune.py,
    architectures/sNN.py)."""
    n_layers, n_nodes = ARCHITECTURES[arch_id]
    return replace(R1, name=f"r1-tune-{arch_id}", n_layers=n_layers,
                   n_nodes=n_nodes)


def surface_from_recordings(spec: RealStudy, data_dir: str,
                            smoothi: bool = False, *, device=None):
    """Data-present path: build the training surface from the raw cell-5
    CSVs (train-r1.py:80-130, 387-811).  r1 trains on Pr3+Pr5; r1-bad on
    Pr3+Pr4."""
    from ionflux_torch.ops.expfit import X0_TRI
    from ionflux_torch.realdata import (PR5_BI_TIMES, PR5_CMA_VOLTAGES,
                                        RealSurfaceConfig, load_recording,
                                        real_surface_smoothi,
                                        real_surface_spline)

    files = {
        "r1": ["pr3-steady-activation-cell-5.csv",
               "pr5-deactivation-cell-5.csv"],
        "r2": ["pr3-steady-activation-cell-5.csv",
               "pr5-deactivation-cell-5.csv"],
        "r1-bad": ["pr3-steady-activation-cell-5.csv",
                   "pr4-inactivation-cell-5.csv"],
    }[spec.surface_dir if spec.surface_dir in ("r1", "r2", "r1-bad")
      else "r1"]
    parts = []
    for fname in files:
        t, i, v = load_recording(os.path.join(data_dir, fname))
        kw = {}
        # per-protocol exp-vs-spline cutoffs and tri-exp initial guesses
        # (train-r1.py:460, 524, 602; x0 at :490 vs x02 at :545/634)
        cfg = RealSurfaceConfig(
            std_cutoff=0.01 if "pr3" in fname else 0.015,
            tri_x0=tuple(X0_TRI) if "pr3" in fname else None)
        if "pr5" in fname:
            kw = dict(bi_exp_times=PR5_BI_TIMES, cma_voltages=PR5_CMA_VOLTAGES)
        if smoothi:
            ts_, vs_, a_, dadt_, d2_ = real_surface_smoothi(
                t, i, v, spec.rgate, spec.constants, cfg, **kw,
                device=device)
        else:
            ts_, vs_, a_, dadt_ = real_surface_spline(
                t, i, v, spec.rgate, spec.constants, cfg, device=device)
        parts.append((ts_, vs_, a_, dadt_))
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(4))


def load_reference_surface(spec: RealStudy):
    """The reference's cached training surface (train-r1.py:380-386), as
    numpy arrays (t, v, a, dadt); t is 0, 1, 2, ... where the cache has no
    t.pt."""
    d = f"{refdir()}/{spec.surface_dir}"
    v = _pt_load(f"{d}/v.pt")
    a = _pt_load(f"{d}/a.pt")
    dadt = _pt_load(f"{d}/dadt.pt")
    t_path = f"{d}/t.pt"
    t = (_pt_load(t_path) if os.path.exists(t_path)
         else np.arange(len(v), dtype=np.float64))
    return t, v, a, dadt


def init_params(spec: RealStudy, generator=None, device=None):
    """The study's initial model; the MLP drawn from ``generator`` (a
    ``torch.Generator`` seeded 0 by default)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if spec.model_kind == "nnf":
        return nnf_init(generator, spec.rgate, spec.n_layers, spec.n_nodes,
                        spec.init_std, device=device)
    return nnd_init(generator, spec.base_hh, spec.n_layers, spec.n_nodes,
                    spec.init_std, device=device)


def wrap_net(spec: RealStudy, net):
    net = net if isinstance(net, MLP) else MLP(net)
    if spec.model_kind == "nnf":
        return NNfParams(net=net, rgate=spec.rgate)
    return NNdParams(net=net, hh=spec.base_hh)


def _net_device(net) -> torch.device:
    return net.layers[0][0].device


def pretrain_r(spec: RealStudy, net):
    """1000-update pretrain on the 100x100 analytic grid (train-r1.py:840-877;
    r2 pretrains through its analytic residual, train-r2.py:869-897), on the
    device of net's weights."""
    x, y = pretrain_grid_r(spec.pretrain_hh, device=_net_device(net))
    residual = None
    if spec.pretrain_residual:
        residual = a_gate_rhs(spec.base_hh, x[:, 1], x[:, 0] * 100.0)
    return fit_surface(net, x, y, residual, iters=1000, lr=1e-3,
                       step_size=None).params


def rollout_health(spec: RealStudy, params) -> tuple[float, bool]:
    """Rollout-health validation: solve the nominal Pr5 template whole-trace
    on the device of params' net; returns (mean |I|, finite?).  Used only
    when the reference's surface caches are absent."""
    dev = _net_device(params.net)
    proto = P.deactivation_protocol(-80.0, dt_ms=1.0, device=dev)
    ts = torch.linspace(0.0, 10000.0, 1001, dtype=torch.float32, device=dev)
    i = simulate(spec.model_kind, params, proto, ts, spec.constants)
    finite = bool(torch.all(torch.isfinite(i)))
    return float(torch.mean(torch.abs(i))) if finite else float("inf"), finite


class RealValidator:
    """Reference-faithful validation rollouts (train-r1.py:928-959): the
    whole-trace MAE of a model, by the segment-chained solve
    (``eval.simulate_long``), against the Pr5 (+Pr3, reported) currents
    recovered from ``REFDIR/r1`` (``realdata.recover_measurements``, with
    r1's own inversion constants whichever study is validated) at the
    retained sample times.  The measurements live on ``device`` (the card
    unless asked); params must be there too."""

    def __init__(self, spec: RealStudy, protocols=("pr5", "pr3"), *,
                 device=None):
        dev = resolve_device(device)
        meas = recover_measurements(f"{refdir()}/r1", CELL5_R1,
                                    HH_CELL5_INIT, device=dev)
        self.spec = spec
        self.cases = []
        for name in protocols:
            tl, i_meas = meas[name]
            idx = torch.as_tensor(
                np.round(tl / protorec.DT_MS).astype(np.int64), device=dev)
            self.cases.append((name, idx, torch.as_tensor(
                np.asarray(i_meas), device=dev).to(torch.float32)))

    def __call__(self, params) -> dict[str, float]:
        out = {}
        for name, idx, i_meas in self.cases:
            i = simulate_long(self.spec.model_kind, params, f"{name}-cell5",
                              self.spec.constants)[idx]
            mae = float(torch.mean(torch.abs(i - i_meas)))
            out[name] = mae if np.isfinite(mae) else float("inf")
        return out


def run_real_study(spec: RealStudy, outdir: str, iters: int | None = None,
                   surface=None, suffix: str = "-2",
                   smoothi: bool = False, *, device=None):
    """Full r-study training: pretrain + chunked Adam (400 updates a chunk)
    with per-chunk validation and best-checkpoint selection
    (train-r1.py:917-960).  smoothi selects the exp-fit surface variant in
    the data-present branch.  Without the reference files the checkpoints
    are selected by training loss behind a rollout-health check; any other
    fault while the validator is built raises."""
    device = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    if surface is None:
        data_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data")
        if os.path.exists(os.path.join(
                data_dir, "pr3-steady-activation-cell-5.csv")):
            surface = surface_from_recordings(spec, data_dir,
                                              smoothi=smoothi, device=device)
        else:
            if smoothi:
                print("--smoothi requested but the raw CSVs are absent; "
                      "training on the reference's cached surfaces "
                      "(which ARE the smoothi product for r1)")
            surface = load_reference_surface(spec)
    _t, v, a, dadt = (np.asarray(s) for s in surface)

    keep = a > 0  # train-r1.py:911-915
    x = torch.as_tensor(np.stack([v[keep] / 100.0, a[keep]], axis=-1),
                        device=device).to(torch.float32)
    y = torch.as_tensor(dadt[keep], device=device).to(torch.float32)
    residual = None
    if spec.model_kind == "nnd":
        residual = a_gate_rhs(spec.base_hh, x[:, 1], x[:, 0] * 100.0)

    params0 = init_params(spec, device=device)
    net = pretrain_r(spec, params0.net)
    print("pretrain done")

    validator = None
    try:
        # Pr5-only during training; the reference sums measured APs + Pr5
        # MAEs (train-r1.py:947-951)
        validator = RealValidator(spec, protocols=("pr5",), device=device)
        print("validator: best-checkpoint selection on Pr5 MAE only "
              "(reference sums measured APs + Pr5, train-r1.py:947-951; "
              "the measured APs currents are not recoverable from the "
              "reference artifacts)")
    except FileNotFoundError as exc:  # the reference files are absent
        print(f"(real validation unavailable: {exc}; "
              "falling back to rollout-health selection)")

    total = iters if iters is not None else spec.iters
    chunk = min(400, total)
    opt_state = init_opt_state(net, 1e-3, spec.step_size, 0.9)
    best = float("inf")
    best_params = wrap_net(spec, net)
    done = 0
    while done < total:
        n = min(chunk, total - done)
        net, opt_state, losses = fit_chunk(
            net, opt_state, x, y, residual, iters=n, lr=1e-3,
            step_size=spec.step_size, gamma=0.9)
        done += n
        train_loss = float(losses[-1])
        params = wrap_net(spec, net)
        if validator is not None:
            maes = validator(params)
            score = maes["pr5"]
            val_txt = " | ".join(
                f"{k} MAE {v_:.6f}" for k, v_ in maes.items())
            losses_meta = [train_loss] + list(maes.values())
        else:
            val, finite = rollout_health(spec, params)
            score = train_loss if finite else float("inf")
            val_txt = (f"rollout mean|I| {val:.4f} "
                       f"({'ok' if finite else 'DIVERGED'})")
            losses_meta = [train_loss, val]
        is_best = score < best
        if is_best:
            best = score
            best_params = params
        print(f"Iter {done} | Loss {train_loss:.6f} | {val_txt}"
              + (" | ===== Current best model =====" if is_best else ""))
        save_checkpoint(outdir, params, opt_state, done, losses_meta,
                        suffix=suffix, is_best=is_best)
    params = wrap_net(spec, net)
    save_pytree(os.path.join(outdir, "model.npz"), params)
    save_pytree(os.path.join(outdir, "best-model.npz"), best_params)
    # model-entire analogue (train-r1.py:964-965)
    save_model_bundle(os.path.join(outdir, "model-entire.npz"), best_params,
                      spec)
    return best_params


def predict_real_study(spec: RealStudy, outdir: str, *, device=None) -> dict:
    """--pred replay for the real studies (reference train-r1.py:219-374):
    per-protocol MAEs of the trained best checkpoint (``outdir/best-model.npz``,
    else ``model.npz``, loaded through the carry-over function) on
    ``device`` (the card unless asked).  The Pr3/Pr5/Pr4 rows score the
    measured currents recovered from ``REFDIR/r1`` and ``REFDIR/r1-bad``;
    the sinewave/APs rows report agreement with the reference's archived
    model trace (``REFDIR/table-2/y{1,2}-*.pt``) where one exists."""
    dev = resolve_device(device)
    path = os.path.join(outdir, "best-model.npz")
    if not os.path.exists(path):
        path = os.path.join(outdir, "model.npz")
    params = load_pytree(path, spec.model_kind, dev)
    meta = os.path.join(outdir, "best-model-checkpoint-2.json")
    if os.path.exists(meta):
        with open(meta) as fh:
            print("Best checkpoint loss:", json.load(fh)["loss"])

    ref = refdir()
    meas = dict(recover_measurements(f"{ref}/r1", CELL5_R1, HH_CELL5_INIT,
                                     device=dev))
    meas.update({"pr4": recover_measurements(
        f"{ref}/r1-bad", CELL5_R1BAD, HH_R1BAD_INIT,
        protocols=("pr3", "pr4"), n_points=30, device=dev)["pr4"]})

    out = {}
    for name, label in (("pr3", "Pr3"), ("pr5", "Pr5"), ("pr4", "Pr4")):
        tl, i_meas = meas[name]
        idx = np.round(np.asarray(tl) / protorec.DT_MS).astype(np.int64)
        i = simulate_long(spec.model_kind, params, f"{name}-cell5",
                          spec.constants).double().cpu().numpy()
        out[name] = float(np.mean(np.abs(i[idx] - np.asarray(i_meas))))
        print(f"{label} prediction | Total Loss {out[name]:.6f}")
    tag = {"nnf": "y1", "nnd": "y2"}[spec.model_kind]
    for name, label in (("sinewave", "Sinewave"), ("aps", "APs")):
        stored = f"{ref}/table-2/{tag}-{name}.pt"
        if spec.name not in ("r1", "r2") or not os.path.exists(stored):
            print(f"{label} prediction: measured currents not recoverable "
                  "(no stored trace for this study), skipped")
            continue
        ref_i = np.asarray(_pt_load(stored)).reshape(-1)
        v, _dt = protorec.load_voltage(f"{name}-cell5")
        ours = gate_current(
            solve_states_real(spec.model_kind, params, f"{name}-cell5"),
            torch.as_tensor(v, device=dev).to(torch.float32), spec.constants)
        out[name] = float(np.mean(np.abs(ours.double().cpu().numpy()
                                         - ref_i)))
        print(f"{label} prediction (vs archived {tag}-{name}.pt trace) | "
              f"Total Loss {out[name]:.6f}")
    return out
