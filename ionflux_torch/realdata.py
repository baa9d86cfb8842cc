"""Raw-recording pipeline (counterpart of ``ionflux/realdata.py``): measured
(t, I, V) time series -> training surface, and the measured currents
recovered from a cached training surface.

Two derivative-estimation variants, as in the reference:
  spline  (default): per-segment Hanning smooth of I + cubic spline -> dI/dt,
          then algebraic inversion to (a, da/dt) (train-r1.py:680-793)
  smoothi (--smoothi): invert to a first, then per-segment tri-/bi-exponential
          or quartic-spline fits of a(t) giving (a, da/dt, d2a/dt2)
          (train-r1.py:422-673)

The known r-gate is solved by the port's ``surface.solve_r_gate`` on the
card unless ``device`` says otherwise; everything else is numpy float64 on
the host.  Cached surfaces (``<dir>/{t,v,a,dadt,d2adt2}.pt``) are read with
``torch.load``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from scipy.interpolate import UnivariateSpline

from ionflux_torch import protocols as P
from ionflux_torch import protorec
from ionflux_torch._device import resolve_device
from ionflux_torch.models.registry import Constants, HHParams
from ionflux_torch.ops.expfit import (X02_TRI, X0_BI, X0_TRI, eval_exp,
                                      fit_exp, fit_exp_ls, is_within)
from ionflux_torch.ops.smoothing import smooth_same_np
from ionflux_torch.surface import (SurfaceConfig, invert_observation,
                                   solve_r_gate, spline_didt)

# Pr5's flat holding tails are bi-exp segments; the -90 mV segment needs
# CMA-ES (train-r1.py:633, 554/640)
PR5_BI_TIMES = (2000, 12000, 22000, 33000, 43000, 53000, 64000, 74000, 84000)
PR5_CMA_VOLTAGES = (-90.0,)


def load_recording(path: str):
    """A cell-5 CSV: columns time, current, voltage (train-r1.py:80-94)."""
    raw = np.loadtxt(path, delimiter=",", skiprows=1)
    return raw[:, 0], raw[:, 1], raw[:, 2]


def _pt_load(path: str) -> np.ndarray:
    """A ``torch.save``d tensor (or array) as numpy."""
    x = torch.load(path, map_location="cpu", weights_only=False)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass(frozen=True)
class RealSurfaceConfig:
    skip: int = 10            # train-r1.py:391
    sparse: int = 7           # train-r1.py:392
    cap_points: int = 70      # 7 ms at 0.1 ms (train-r1.py:99-101)
    extra_points: int = 20    # train-r1.py:118
    std_cutoff: float = 0.01  # exp-vs-spline switch (train-r1.py:460)
    smooth_window: int = 51   # a-smoothing for spline segments (:497)
    spline_k: int = 4         # "want smooth 2nd derivative" (:498)
    spline_s: float = 0.2     # (:499)
    sine_window: int = 21     # sinewave-window smoothing (:566)
    sine_spline_k: int = 5    # sinewave-window spline order (:567)
    # tri-exp initial guess: the reference uses x0 for Pr3 segments and x02
    # for Pr4/sinewave/Pr5 (train-r1.py:490 vs :545/634); None -> X02_TRI
    tri_x0: tuple | None = None
    # exp-fit optimiser: "fmin" = reference-faithful single Nelder-Mead
    # (+CMA fallback, train-r1.py:490/555); "ls" = the grid-seeded
    # varpro + LM pipeline (ops/expfit.fit_exp_ls)
    fit_method: str = "fmin"


def _recording_protocol(t: np.ndarray, v: np.ndarray,
                        device=None) -> P.Protocol:
    # recordings are nominally uniform; tolerate f32-rounded time columns
    device = resolve_device(device)
    dt = (t[-1] - t[0]) / (len(t) - 1)
    f32 = torch.float32
    return P.Protocol(torch.tensor(np.float32(t[0]), dtype=f32,
                                   device=device),
                      torch.tensor(np.float32(dt), dtype=f32, device=device),
                      torch.as_tensor(np.asarray(v, np.float32),
                                      device=device))


def _known_r(t, v, rgate: HHParams, device=None):
    proto = _recording_protocol(t, v, device)
    ts = torch.as_tensor(np.asarray(t, np.float32), device=proto.v.device)
    r = solve_r_gate(proto, ts, rgate).cpu().numpy().astype(np.float64)
    k3 = np.float64(rgate.p5) * np.exp(np.float64(rgate.p6) * v)
    k4 = np.float64(rgate.p7) * np.exp(-np.float64(rgate.p8) * v)
    drdt = -k3 * r + k4 * (1.0 - r)
    return r, drdt


def real_surface_spline(t, i, v, rgate: HHParams, c: Constants,
                        cfg: RealSurfaceConfig = RealSurfaceConfig(),
                        extra_changes: np.ndarray | None = None, *,
                        device=None):
    """Spline path -> subsampled (t, v, a, dadt) (train-r1.py:680-801)."""
    t = np.asarray(t, np.float64)
    i = np.asarray(i, np.float64)
    v = np.asarray(v, np.float64)
    r, drdt = _known_r(t, v, rgate, device)
    edges = P.segment_edges(t, v)
    i_smooth, didt = spline_didt(
        t, i, edges, SurfaceConfig(smooth_window=61, spline_k=3, spline_s=0.0))
    a, dadt = invert_observation(i_smooth, r, v, didt, drdt, c)
    mask = P.training_mask(v, cfg.cap_points, cfg.extra_points, extra_changes)
    sl = slice(cfg.skip, None, cfg.sparse)
    return t[mask][sl], v[mask][sl], a[mask][sl], dadt[mask][sl]


def real_surface_smoothi(t, i, v, rgate: HHParams, c: Constants,
                         cfg: RealSurfaceConfig = RealSurfaceConfig(),
                         extra_changes: np.ndarray | None = None,
                         bi_exp_times: tuple = (), cma_voltages: tuple = (),
                         sine_times: tuple = (), *, device=None):
    """--smoothi path -> subsampled (t, v, a, dadt, d2adt2)
    (train-r1.py:422-673).

    bi_exp_times: segment-interior times forced to bi-exp (the Pr5 flat tails,
    train-r1.py:633); cma_voltages: segment voltages needing the CMA-ES
    optimiser (the hard -90 mV segments, train-r1.py:554, 640); sine_times:
    segment-interior times marking a sinewave window: those segments take a
    lighter smooth and a quintic spline regardless of their std
    (train-r1.py:564-573)."""
    t = np.asarray(t, np.float64)
    i = np.asarray(i, np.float64)
    v = np.asarray(v, np.float64)
    r, _ = _known_r(t, v, rgate, device)
    a_raw = i / (np.float64(c.g) * r * (v - np.float64(c.e)))

    cap = P.capacitance_mask(v, cfg.cap_points, extra_changes)
    tt, aa = t[cap], a_raw[cap]
    edges = P.segment_edges(t, v)

    ao = np.zeros_like(t)
    dadto = np.zeros_like(t)
    d2o = np.zeros_like(t)
    t_i = 0.0
    for t_f in edges:
        idx = np.where((tt >= t_i) & (tt < t_f))[0]
        t_i = t_f
        if len(idx) <= cfg.smooth_window:
            continue  # degenerate segment; masked out of training anyway
        tfit = tt[idx]
        afit_raw = aa[idx]
        full = np.where((t >= tfit[0]) & (t <= tfit[-1]))[0]
        seg_v = v[full[0]]
        in_sine = any(is_within(tfit, ts_) for ts_ in sine_times)
        if np.std(afit_raw) > cfg.std_cutoff and not in_sine:
            tl = tfit - tfit[0]
            if any(is_within(tfit, tb) for tb in bi_exp_times):
                if cfg.fit_method == "ls":
                    x = fit_exp_ls(tl, afit_raw, "bi", X0_BI)
                else:
                    x = fit_exp(tl, afit_raw, "bi", X0_BI)
                vals = eval_exp("bi", t[full] - tfit[0], x)
            else:
                use_cma = any(abs(seg_v - cv) < 0.5 for cv in cma_voltages)
                tri_x0 = (np.asarray(cfg.tri_x0) if cfg.tri_x0 is not None
                          else X02_TRI)
                if cfg.fit_method == "ls":
                    x = fit_exp_ls(tl, afit_raw, "tri", tri_x0)
                else:
                    x = fit_exp(tl, afit_raw, "tri", tri_x0,
                                use_cma=use_cma)
                vals = eval_exp("tri", t[full] - tfit[0], x)
            ao[full], dadto[full], d2o[full] = vals
        else:
            win = cfg.sine_window if in_sine else cfg.smooth_window
            k = cfg.sine_spline_k if in_sine else cfg.spline_k
            asm = smooth_same_np(afit_raw, win)
            spl = UnivariateSpline(tfit, asm, k=k)
            spl.set_smoothing_factor(cfg.spline_s)
            ao[full] = spl(t[full])
            dadto[full] = spl(t[full], 1)
            d2o[full] = spl(t[full], 2)

    mask = P.training_mask(v, cfg.cap_points, cfg.extra_points, extra_changes)
    sl = slice(cfg.skip, None, cfg.sparse)
    return (t[mask][sl], v[mask][sl], ao[mask][sl], dadto[mask][sl],
            d2o[mask][sl])


# ---------------------------------------------------------------------------
# smoothi cache-refit parity
# ---------------------------------------------------------------------------

def smoothi_refit_cache(surface_dir: str, protocols=("pr3", "pr5"),
                        n_min: int = 12, max_fit_points: int = 2000,
                        seed: int = 0, n_points_cap: int = 70,
                        max_segments: int | None = None):
    """Re-run the --smoothi segment-fit dispatch on the retained-sample
    lattice of a cached surface and compare against the cache.

    The archived r-study surfaces ({a,dadt,d2adt2}.pt) were produced WITH
    --smoothi, so re-fitting the same segment dispatch (std cutoffs, bi-exp
    windows, initial guesses; exp optimiser ``fit_exp_ls``) to the cached a
    must reproduce dadt/d2adt2.  Exp segments fit on at most max_fit_points
    samples (strided); evaluation is at every retained sample.  Returns
    {protocol: {t, v, a, dadt, d2, a_ref, dadt_ref, d2_ref, branch}} with
    branch one of 'tri'/'bi'/'spline' per retained sample ('' = skipped
    degenerate segment)."""
    v = np.asarray(_pt_load(f"{surface_dir}/v.pt"), np.float64)
    a = np.asarray(_pt_load(f"{surface_dir}/a.pt"), np.float64)
    dadt = np.asarray(_pt_load(f"{surface_dir}/dadt.pt"), np.float64)
    d2 = np.asarray(_pt_load(f"{surface_dir}/d2adt2.pt"), np.float64)
    sel_t, sel_m = _cache_lattice(surface_dir, protocols, v,
                                  n_points=n_points_cap)
    # per-protocol dispatch parameters (train-r1.py:460/490 vs :602/633/640;
    # pr4 as in train-r1-bad.py:459-492)
    params = {"pr3": dict(cutoff=0.01, tri_x0=X0_TRI, bi_times=()),
              "pr4": dict(cutoff=0.015, tri_x0=X02_TRI, bi_times=()),
              "pr5": dict(cutoff=0.015, tri_x0=X02_TRI,
                          bi_times=PR5_BI_TIMES)}
    out = {}
    for name in protocols:
        tl, m = sel_t[name], sel_m[name]
        vl, al, dl, d2l = v[m], a[m], dadt[m], d2[m]
        pp = params[name]
        vfull, dt = protorec.load_voltage(f"{name}-cell5")
        edges = P.segment_edges(np.arange(len(vfull)) * dt, vfull)
        ao = np.zeros_like(tl)
        do = np.zeros_like(tl)
        d2o = np.zeros_like(tl)
        branch = np.full(len(tl), "", dtype=object)
        t_i = 0.0
        n_fitted = 0
        for t_f in edges:
            idx = np.where((tl >= t_i) & (tl < t_f))[0]
            t_i = t_f
            if len(idx) < n_min:
                continue
            if max_segments is not None and n_fitted >= max_segments:
                break
            n_fitted += 1
            ts_, as_ = tl[idx], al[idx]
            tloc = ts_ - ts_[0]
            if np.std(as_) > pp["cutoff"]:
                kind = ("bi" if any(is_within(ts_, tb)
                                    for tb in pp["bi_times"]) else "tri")
                stride = max(1, len(idx) // max_fit_points)
                x = fit_exp_ls(tloc[::stride], as_[::stride], kind,
                               pp["tri_x0"] if kind == "tri" else X0_BI,
                               seed=seed)
                ao[idx], do[idx], d2o[idx] = eval_exp(kind, tloc, x)
                branch[idx] = kind
            else:
                asm = smooth_same_np(as_, 51)
                spl = UnivariateSpline(ts_, asm, k=4)
                spl.set_smoothing_factor(0.2)
                ao[idx] = spl(ts_)
                do[idx] = spl(ts_, 1)
                d2o[idx] = spl(ts_, 2)
                branch[idx] = "spline"
        out[name] = dict(t=tl, v=vl, a=ao, dadt=do, d2=d2o,
                         a_ref=al, dadt_ref=dl, d2_ref=d2l, branch=branch)
    return out


# ---------------------------------------------------------------------------
# Measured-current recovery from a cached training surface
# ---------------------------------------------------------------------------

def _cache_lattice(surface_dir: str, protocols, v: np.ndarray,
                   n_points: int = 70):
    """Retained-sample split of a cached surface: {name: local times} and
    {name: bool selector into the concatenated cache arrays}.

    r1/r2 store t.pt (Pr3+Pr5 concatenated on a global clock,
    train-r1.py:800-803); r1-bad stores none: its lattice is rederived
    from the recorded protocols' own masks, and the cached v must equal the
    protocol's samples there."""
    if os.path.exists(f"{surface_dir}/t.pt"):
        # the PR3_N split below is specific to the r1/r2 Pr3+Pr5 caches
        if tuple(protocols) != ("pr3", "pr5"):
            raise ValueError(
                "the t.pt split is hardcoded for protocols=('pr3','pr5'); "
                f"got {tuple(protocols)}: use the mask-derived branch "
                "(surface dirs without t.pt) for other pairs")
        t = np.asarray(_pt_load(f"{surface_dir}/t.pt"))
        n1 = protorec.PR3_N
        in3 = np.round(t / protorec.DT_MS).astype(np.int64) < n1
        sel_t = {protocols[0]: t[in3],
                 protocols[1]: t[~in3] - (n1 - 1) * protorec.DT_MS}
        sel_m = {protocols[0]: in3, protocols[1]: ~in3}
    else:
        # rebuild the retained-sample lattice from the protocol masks
        sel_t, sel_m, pos = {}, {}, 0
        for name in protocols:
            vfull, dt = protorec.load_voltage(f"{name}-cell5")
            m = P.training_mask(vfull, n_points=n_points)
            idx = np.where(m)[0][10::7]
            np.testing.assert_array_equal(vfull[idx], v[pos:pos + len(idx)])
            sel_t[name] = idx * dt
            sel = np.zeros(len(v), bool)
            sel[pos:pos + len(idx)] = True
            sel_m[name] = sel
            pos += len(idx)
    return sel_t, sel_m


def _r_gate_chained(name: str, tl: np.ndarray, rgate: HHParams, dtype,
                    dev) -> np.ndarray:
    """The known r-gate at a recording's local retained times tl (ms), from
    r = 1 at its start, by the segment-chained solve: one local clock per
    sweep of ``protorec.SWEEPS`` (the whole recording is one sweep
    otherwise), r carried across sweeps.  Each sweep's protocol holds the
    next sweep's first sample, so the solve crosses the 0.1 ms ramp into it
    as one clock over the recording does; no step straddles either end of
    a ramp (``breakpoints``).  Only the sweeps up to the last retained time
    are solved."""
    v, dt = protorec.load_voltage(f"{name}-cell5")
    _n, period = protorec.SWEEPS.get(f"{name}-cell5", (1, v.size))
    idx = np.round(np.asarray(tl) / dt).astype(np.int64)
    sweep = idx // period
    r = np.empty(idx.size)
    r0 = 1.0
    for k in range(int(sweep.max()) + 1 if idx.size else 0):
        seg = v[k * period:(k + 1) * period + 1]
        proto = P.from_time_series(np.arange(seg.size) * dt, seg,
                                   dtype=dtype, device=dev)
        sel = sweep == k
        t_loc = (idx[sel] - k * period) * dt
        t_out = np.unique(np.concatenate([[0.0], t_loc,
                                          [(seg.size - 1) * dt]]))
        ramp = np.flatnonzero(seg[1:] != seg[:-1])
        bps = np.unique(np.concatenate([ramp, ramp + 1])) * dt
        rs = solve_r_gate(proto, torch.as_tensor(t_out, device=dev).to(
            dtype), rgate, r0=r0, max_steps=1_000_000, buffer_size=65536,
            breakpoints=torch.as_tensor(bps, device=dev).to(dtype)
        ).cpu().numpy()
        r[sel] = rs[np.searchsorted(t_out, t_loc)]
        r0 = float(rs[-1])
    return r


def recover_measurements(surface_dir: str, c: Constants, rgate: HHParams,
                         protocols=("pr3", "pr5"), n_points: int = 70,
                         dtype=None, *, device=None):
    """Recover the (smoothed) measured currents from a cached r-study
    training surface.

    The surface stores a = I_smoothed / (g r (V - E)) at the retained sample
    times (train-r1.py:748-793), so with the known r-gate solved on the
    recorded protocols the measured current is I = a g r (V - E).
    protocols/n_points select the study's concatenation: r1/r2 cached
    Pr3+Pr5 with a 7 ms mask; r1-bad cached Pr3+Pr4 with 3 ms
    (train-r1-bad.py:76-96) and stores no t.pt.  ``dtype`` (default torch's
    default dtype, as JAX's follows ``jax_enable_x64``) is the r-gate
    solve's, on ``device`` (the card unless asked).

    A stated difference from JAX: the r-gate is solved per sweep on local
    clocks, chained (``_r_gate_chained``), where JAX solves each 46-93 s
    recording on one clock.  In float64 the two agree; in float32 one
    clock loses resolution late in a recording and crawls through the
    step ramps there, which puts a few late points of JAX's float32
    recovery up to 6e-2 of the range off the exact r-gate (PERF.md).

    Returns {name: (t_local_ms, i)} per protocol."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    dev = resolve_device(device)
    v = np.asarray(_pt_load(f"{surface_dir}/v.pt"))
    a = np.asarray(_pt_load(f"{surface_dir}/a.pt"))
    sel_t, sel_m = _cache_lattice(surface_dir, protocols, v, n_points)
    out = {}
    for name in protocols:
        tl, sel = sel_t[name], sel_m[name]
        r = _r_gate_chained(name, tl, rgate, dtype, dev)
        i = a[sel] * float(c.g) * r * (v[sel] - float(c.e))
        out[name] = (tl, i)
    return out
