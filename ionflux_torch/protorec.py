"""The recorded cell-5 voltage-clamp protocols (counterpart of
``ionflux/protorec.py``).

Pr3, Pr4, Pr5 and the sinewave protocol have a closed form and are built by
numpy from the constants below; the action-potential waveform exists only as
a stored asset.  The assets are the JAX package's ``*.npz`` files, read in
place (``ASSET_DIR``, read when a function runs).

The reconstruction tools recover a protocol from stored simulation
artifacts: ``invert_gt_a`` (algebraic voltage inversion of a GroundTruth_a
(a, u) trajectory), ``boundaries_from_trace`` / ``level_from_ratio`` /
``snap_segments`` (step structure from clean currents), ``fit_voltage``
(gradient-based trajectory fitting: a differentiable fixed-step RK4 through
torch autograd, rematerialised by ``torch.utils.checkpoint`` per block of
steps, and Adam under a cosine-decayed rate as ``optax.adam`` with
``optax.cosine_decay_schedule`` computes it) and ``save_asset``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch._device import resolve_device
from ionflux_torch.models.registry import MARKOV_B06, MarkovParams

DT_MS = 0.1  # all cell-5 recordings are sampled at 0.1 ms

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "ionflux", "assets", "protocols")


# ---------------------------------------------------------------------------
# 1. Algebraic voltage inversion from GroundTruth_a (a, u) trajectories
# ---------------------------------------------------------------------------

def _gta_coeffs(p: MarkovParams, v: np.ndarray):
    """K1, K2, K3 of the reduced a-gate ODE (figure-1.py:100-110), numpy."""
    a1 = p.p1 * np.exp(p.p2 * v)
    b1 = p.p3 * np.exp(-p.p4 * v)
    a2 = p.p9 * np.exp(p.p10 * v)
    b2 = p.p11 * np.exp(-p.p12 * v)
    return a1 * a2 + a1 * b2 + b1 * b2, a1 + b1 + a2 + b2, a1 * a2


def invert_gt_a(a: np.ndarray, u: np.ndarray, dt: float = DT_MS,
                params: MarkovParams = MARKOV_B06,
                v_lo: float = -140.0, v_hi: float = 80.0,
                n_outer: int = 8) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover V(t) from a stored GroundTruth_a (a, u=da/dt) trajectory.

    Solves R(V) = u' + K1(V)a + K2(V)u - K3(V) = 0 per sample.  R can have
    several roots, so a coarse grid argmin seeds a Jacobi-style loop:
    median-filter the estimate for temporal continuity, then Newton-refine
    every sample in parallel.  Returns (V, |residual|, |dR/dV| sensitivity);
    samples with tiny sensitivity carry little voltage information (the gate
    barely moves there) and should be filled from structure priors.
    """
    a = np.asarray(a, np.float64)
    u = np.asarray(u, np.float64)
    dudt = np.gradient(u, dt)

    vg = np.linspace(v_lo, v_hi, int((v_hi - v_lo) * 2) + 1)  # 0.5 mV grid
    k1g, k2g, k3g = _gta_coeffs(params, vg)
    v = np.empty(a.shape)
    for s in range(0, len(a), 40000):
        e = min(s + 40000, len(a))
        r = (dudt[s:e, None] + k1g[None, :] * a[s:e, None]
             + k2g[None, :] * u[s:e, None] - k3g[None, :])
        v[s:e] = vg[np.argmin(np.abs(r), axis=1)]

    from scipy.ndimage import median_filter

    def _resid(v):
        k1, k2, k3 = _gta_coeffs(params, v)
        return dudt + k1 * a + k2 * u - k3

    def _dresid(v, h=0.01):
        k1p, k2p, k3p = _gta_coeffs(params, v + h)
        k1m, k2m, k3m = _gta_coeffs(params, v - h)
        return ((k1p - k1m) * a + (k2p - k2m) * u - (k3p - k3m)) / (2 * h)

    for _ in range(n_outer):
        v = median_filter(v, size=15, mode="nearest")
        for _ in range(12):
            dr = _dresid(v)
            dr = np.where(np.abs(dr) < 1e-18, 1e-18, dr)
            v = np.clip(v - np.clip(_resid(v) / dr, -10, 10), v_lo, v_hi)

    return v, np.abs(_resid(v)), np.abs(_dresid(v, h=0.05))


# ---------------------------------------------------------------------------
# 2. Step-boundary detection from clean currents
# ---------------------------------------------------------------------------

def boundaries_from_trace(i_clean: np.ndarray, rel_thresh: float = 0.15,
                          floor: float = 1e-5) -> np.ndarray:
    """Indices of the *first sample at a new voltage level* in a clean step-
    protocol current.  A voltage step multiplies I = g a r (V - E) by the
    driving-force ratio within one sample while (a, r) stay continuous, so
    relative one-sample jumps far above the smooth trend mark boundaries."""
    i_clean = np.asarray(i_clean, np.float64).reshape(-1)
    rel = np.abs(np.diff(i_clean)) / np.maximum(np.abs(i_clean[:-1]), floor)
    cand = np.where(rel > rel_thresh)[0]
    out: list[int] = []
    for idx in cand:
        if out and idx - out[-1] <= 3:
            continue  # same edge (interp ramp spans 2 samples)
        out.append(int(idx))
    return np.asarray([i + 1 for i in out], dtype=np.int64)


def level_from_ratio(i_clean: np.ndarray, b: int, v_prev: float,
                     e: float) -> float:
    """Voltage level after boundary sample ``b`` from the one-sample driving-
    force ratio (valid when the gates move slowly across the step, i.e. for
    steps between hyperpolarised levels where a is near-frozen)."""
    return e + (i_clean[b] / i_clean[b - 1]) * (v_prev - e)


def snap_segments(v: np.ndarray, sens: np.ndarray, bounds: np.ndarray,
                  sens_thresh: float = 1e-7) -> list[tuple[int, int, float]]:
    """Per-segment constant levels from an inverted-voltage estimate: the
    sensitivity-weighted median over well-conditioned samples (NaN when the
    whole segment is ill-conditioned; fill those by ratio/prior)."""
    edges = np.concatenate([[0], bounds, [len(v)]])
    segs = []
    for s, e in zip(edges[:-1], edges[1:]):
        ok = sens[s:e] > sens_thresh
        lvl = float(np.median(v[s:e][ok])) if ok.sum() > 10 else float("nan")
        segs.append((int(s), int(e), lvl))
    return segs


# ---------------------------------------------------------------------------
# 3. Gradient-based trajectory-consistent voltage fitting
# ---------------------------------------------------------------------------
#
# Joint trajectory fitting: integrate gt_a and the d0-HH candidate through a
# differentiable fixed-step RK4 and descend on the per-sample voltages.  The
# gt_a trajectory term pins V wherever the gate moves (slow content); the
# current term pins the fast edges the gate low-passes away (AP upstrokes).

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults
FIT_BLOCK = 256   # RK4 steps rematerialised together in the backward pass


def _cosine_lr(lr: float, iters: int, k: int, alpha: float = 0.01) -> float:
    """optax.cosine_decay_schedule(lr, iters, alpha) at step k."""
    frac = min(k, iters) / iters
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + np.cos(np.pi * frac)) + alpha)


def fit_voltage(v0: np.ndarray, a_ref: np.ndarray, i_clean: np.ndarray,
                hh_params, c, params: MarkovParams = MARKOV_B06,
                dt: float = DT_MS, free: np.ndarray | None = None,
                stages=((1e6, 1.0, 0.3, 400), (1e5, 100.0, 1.0, 800),
                        (1e6, 100.0, 0.05, 300)),
                verbose: bool = True, *, device=None) -> np.ndarray:
    """Fit per-sample V(t) to a stored gt_a a-trajectory + clean HH current.

    stages: (w_a, w_i, adam_lr, iters) triples run in sequence, each with a
    fresh Adam (b1 0.9, b2 0.999, eps 1e-8 added to the root of the second
    moment) and a cosine-decayed rate (to 1% of adam_lr).  ``free`` masks
    which samples may move (None = all); fixed samples keep v0.  Runs in
    torch's default dtype on ``device`` (the card unless asked)."""
    dev = resolve_device(device)
    dtype = torch.get_default_dtype()
    pm = [float(x) for x in params]
    ph = [float(x) for x in hh_params]
    g, e = float(c.g), float(c.e)

    def tens(x, dt_=dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt_)

    a_ref = tens(np.asarray(a_ref, np.float64))
    i_ref = tens(np.asarray(i_clean, np.float64).reshape(-1))
    v_fixed = tens(np.asarray(v0, np.float64))
    free_m = (torch.ones(len(v0), dtype=torch.bool, device=dev) if free is None
              else tens(np.asarray(free, bool), torch.bool))

    def rhs(y, v):
        a1 = pm[0] * torch.exp(pm[1] * v)
        b1 = pm[2] * torch.exp(-pm[3] * v)
        a2 = pm[8] * torch.exp(pm[9] * v)
        b2 = pm[10] * torch.exp(-pm[11] * v)
        k1 = a1 * a2 + a1 * b2 + b1 * b2
        k2 = a1 + b1 + a2 + b2
        h1 = ph[0] * torch.exp(ph[1] * v)
        h2 = ph[2] * torch.exp(-ph[3] * v)
        h3 = ph[4] * torch.exp(ph[5] * v)
        h4 = ph[6] * torch.exp(-ph[7] * v)
        return torch.stack([y[1], -k1 * y[0] - k2 * y[1] + a1 * a2,
                            h1 * (1 - y[2]) - h2 * y[2],
                            -h3 * y[3] + h4 * (1 - y[3])])

    def block(y, v0s, v1s):
        out = []
        for v0_, v1_ in zip(v0s, v1s):
            vm = 0.5 * (v0_ + v1_)
            k1 = rhs(y, v0_)
            k2 = rhs(y + 0.5 * dt * k1, vm)
            k3 = rhs(y + 0.5 * dt * k2, vm)
            k4 = rhs(y + dt * k3, v1_)
            y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            out.append(y)
        return torch.stack(out)

    def rollout(v):
        y = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev)
        parts = [y[None]]
        for s in range(0, v.shape[0] - 1, FIT_BLOCK):
            e_ = min(s + FIT_BLOCK, v.shape[0] - 1)
            ys = torch.utils.checkpoint.checkpoint(
                block, y, v[s:e_], v[s + 1:e_ + 1], use_reentrant=False)
            parts.append(ys)
            y = ys[-1]
        return torch.cat(parts)

    def loss(v, w_a, w_i):
        vv = torch.where(free_m, v, v_fixed)
        ys = rollout(vv)
        la = torch.mean((ys[:, 0] - a_ref) ** 2)
        li = torch.mean((g * ys[:, 2] * ys[:, 3] * (vv - e) - i_ref) ** 2)
        return w_a * la + w_i * li, la, li

    v = v_fixed.clone()
    for w_a, w_i, lr, iters in stages:
        mu = torch.zeros_like(v)
        nu = torch.zeros_like(v)
        for it in range(iters):
            vg = v.detach().requires_grad_(True)
            total, la, li = loss(vg, w_a, w_i)
            (grad,) = torch.autograd.grad(total, vg)
            mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
            nu = (1 - ADAM_B2) * grad * grad + ADAM_B2 * nu
            mu_hat = mu / (1 - ADAM_B1 ** (it + 1))
            nu_hat = nu / (1 - ADAM_B2 ** (it + 1))
            v = v - _cosine_lr(lr, iters, it) * (
                mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
            if verbose and (it % 200 == 0 or it == iters - 1):
                print(f"  fit_voltage lr={lr} it {it:4d} "
                      f"a-RMSE {float(torch.sqrt(la)):.3e} "
                      f"i-RMSE {float(torch.sqrt(li)):.3e}", flush=True)
    v = torch.where(free_m, v, v_fixed)
    return v.cpu().numpy()


def _steps(n: int, segments: list[tuple[int, float]]) -> np.ndarray:
    """Per-sample voltage from (first_sample_index, level) pairs."""
    v = np.empty(n, np.float64)
    starts = [s for s, _ in segments] + [n]
    for (s, lvl), e in zip(segments, starts[1:]):
        v[s:e] = lvl
    return v


def sinewave_cell5_voltage() -> np.ndarray:
    """The sinewave protocol (80,000 samples, 8 s): a step scaffold with the
    published Beattie-2018 3-sine waveform in the window (3000, 6500] ms,
    referenced to t0 = 2500 ms."""
    n = 80000
    t = np.arange(n) * DT_MS
    v = _steps(n, [
        (0, -80.0),        # hold
        (2501, -120.0),    # 50 ms leak step
        (3001, -80.0),
        (5001, 40.0),      # 1 s activation
        (15001, -120.0),   # 0.5 s
        (20001, -80.0),
        (30001, 0.0),      # sine window, filled below
        (65001, -120.0),
        (70001, -80.0),
    ])
    w = np.s_[30001:65001]
    x = t[w] - 2500.0
    v[w] = (-30.0 + 54.0 * np.sin(0.007 * x) + 26.0 * np.sin(0.037 * x)
            + 10.0 * np.sin(0.19 * x))
    return v


# Pr3 (steady activation, 7 sweeps).  Sweep-local layout after the leak
# step, in samples (0.1 ms):
#   -120 x 500 | -80 x 2000 | test x 50000 | -40 x 10000 | -120 x 5000 |
#   -80 until the next sweep.  First leak sample 3791, period 82580 samples,
#   total 578060 samples.
PR3_TEST_V = (-60.0, -40.0, -20.0, 0.0, 20.0, 40.0, 60.0)
PR3_N = 578060
PR3_LEAK0 = 3791
PR3_PERIOD = 82580


def pr3_cell5_voltage() -> np.ndarray:
    segs: list[tuple[int, float]] = [(0, -80.0)]
    for k, tv in enumerate(PR3_TEST_V):
        s = PR3_LEAK0 + k * PR3_PERIOD
        segs += [(s, -120.0), (s + 500, -80.0), (s + 2500, tv),
                 (s + 52500, -40.0), (s + 62500, -120.0), (s + 67500, -80.0)]
    return _steps(PR3_N, segs)


# Pr5 (deactivation, 9 sweeps).  Sweep-local layout:
#   -120 x 500 | -80 x 2000 | +50 x 20000 | test x 60000 | -120 x 5000 |
#   -80 until the next sweep.  First leak sample 4112, period 103224
#   samples, total 9 full periods.
PR5_TEST_V = (-120.0, -110.0, -100.0, -90.0, -80.0, -70.0, -60.0, -50.0,
              -40.0)
PR5_N = 9 * 103224
PR5_LEAK0 = 4112
PR5_PERIOD = 103224


def pr5_cell5_voltage() -> np.ndarray:
    segs: list[tuple[int, float]] = [(0, -80.0)]
    for k, tv in enumerate(PR5_TEST_V):
        s = PR5_LEAK0 + k * PR5_PERIOD
        segs += [(s, -120.0), (s + 500, -80.0), (s + 2500, 50.0),
                 (s + 22500, tv), (s + 82500, -120.0), (s + 87500, -80.0)]
    return _steps(PR5_N, segs)


# Pr4 (inactivation, 16 sweeps).  Sweep-local layout: -80 | -120 x 500
# (leak) | -80 x 2000 | +50 x 6000 | -90 x 600 | test x 1500 | -120 x 5000 |
# -80 until the next sweep.  First leak sample 2954, period 29006 samples,
# total 464096 samples.
PR4_TEST_V = tuple(float(x) for x in range(-100, 60, 10))
PR4_N = 464096
PR4_LEAK0 = 2954
PR4_PERIOD = 29006


def pr4_cell5_voltage() -> np.ndarray:
    segs: list[tuple[int, float]] = [(0, -80.0)]
    for k, tv in enumerate(PR4_TEST_V):
        s = PR4_LEAK0 + k * PR4_PERIOD
        segs += [(s, -120.0), (s + 500, -80.0), (s + 2500, 50.0),
                 (s + 8500, -90.0), (s + 9100, tv), (s + 10600, -120.0),
                 (s + 15600, -80.0)]
    return _steps(PR4_N, segs)


# Sweep structure of the multi-sweep recordings: (n_sweeps, samples/sweep).
SWEEPS = {
    "pr3-cell5": (7, PR3_PERIOD),
    "pr4-cell5": (16, PR4_PERIOD),
    "pr5-cell5": (9, PR5_PERIOD),
}

_ANALYTIC = {
    "pr3-cell5": pr3_cell5_voltage,
    "pr4-cell5": pr4_cell5_voltage,
    "pr5-cell5": pr5_cell5_voltage,
    "sinewave-cell5": sinewave_cell5_voltage,
}


def save_asset(name: str, v: np.ndarray, dt: float = DT_MS) -> str:
    os.makedirs(ASSET_DIR, exist_ok=True)
    path = os.path.join(ASSET_DIR, f"{name}.npz")
    np.savez_compressed(path, v=np.asarray(v, np.float32), dt=np.float64(dt))
    return path


def load_voltage(name: str) -> tuple[np.ndarray, float]:
    """Per-sample (voltage, dt).  Prefers the stored asset (exact recovered
    samples, e.g. the APs waveform); falls back to the closed form for
    protocols with a closed form."""
    path = os.path.join(ASSET_DIR, f"{name}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["v"].astype(np.float64), float(z["dt"])
    if name in _ANALYTIC:
        return _ANALYTIC[name](), DT_MS
    raise FileNotFoundError(f"no protocol asset '{name}' in {ASSET_DIR}")


def protocol(name: str, dtype=torch.float32, device=None) -> P.Protocol:
    """A recorded protocol as a Protocol (linear interpolation at 0.1 ms),
    on the card unless ``device`` says otherwise."""
    v, dt = load_voltage(name)
    t = np.arange(len(v)) * dt
    return P.from_time_series(t, v, dtype=dtype, device=device)


def available() -> list[str]:
    names = set(_ANALYTIC)
    if os.path.isdir(ASSET_DIR):
        names |= {f[:-4] for f in os.listdir(ASSET_DIR) if f.endswith(".npz")}
    return sorted(names)
