"""Tri-/bi-exponential segment fits (counterpart of ``ionflux/ops/expfit.py``,
numpy and scipy, copied): the --smoothi derivative-estimation variant
(reference train-r1.py:422-673).

Per constant-voltage segment the gate trajectory a(t) is fitted with
  tri_exp: a e^{-bt} + c e^{-dt} + e e^{-ft} + g   (7 params)
  bi_exp:  a e^{-bt} + c e^{-dt} + g               (5 params)
whose analytic 1st/2nd derivatives give da/dt and d2a/dt2 exactly — the
reference's route to smooth second derivatives on noisy real data.

Fitting: Nelder-Mead (scipy fmin, as train-r1.py:490) with a CMA-ES fallback
for the hard segments (the reference calls pints.fmin at -90 mV,
train-r1.py:555; here the port's fit.cmaes.fmin, seeded as the
reference's through ``np.random.default_rng``).
"""

from __future__ import annotations

import numpy as np
from scipy import optimize

from ionflux_torch.fit.cmaes import fmin as cma_fmin

# reference initial guesses (train-r1.py:426-427, 440)
X0_TRI = np.array([1.0, 1.0 / 100, 0.5, 1.0 / 200, 0.25, 1.0 / 400, 0.1])
X02_TRI = np.array([0.7, 1.0 / 50, 0.2, 1.0 / 100, 0.1, 1.0 / 200, 0.01])
X0_BI = np.array([0.7, 1.0 / 50, 0.2, 1.0 / 100, 0.01])


def tri_exp(t, x):
    a, b, c, d, e, f, g = x
    return a * np.exp(-b * t) + c * np.exp(-d * t) + e * np.exp(-f * t) + g


def dtri_exp(t, x):
    a, b, c, d, e, f, g = x
    return (-a * b * np.exp(-b * t) - c * d * np.exp(-d * t)
            - e * f * np.exp(-f * t))


def d2tri_exp(t, x):
    a, b, c, d, e, f, g = x
    return (a * b * b * np.exp(-b * t) + c * d * d * np.exp(-d * t)
            + e * f * f * np.exp(-f * t))


def bi_exp(t, x):
    a, b, c, d, g = x
    return a * np.exp(-b * t) + c * np.exp(-d * t) + g


def dbi_exp(t, x):
    a, b, c, d, g = x
    return -a * b * np.exp(-b * t) - c * d * np.exp(-d * t)


def d2bi_exp(t, x):
    a, b, c, d, g = x
    return a * b * b * np.exp(-b * t) + c * d * d * np.exp(-d * t)


def is_within(r, x) -> bool:
    """train-r1.py:453-454."""
    return bool(np.min(r) < x < np.max(r))


def fit_exp(t: np.ndarray, a: np.ndarray, kind: str = "tri",
            x0: np.ndarray | None = None, use_cma: bool = False,
            max_iter: int = 1000, restarts: int = 0):
    """Fit a segment; returns (value, d1, d2) callables' params.

    t is segment-local time (the reference shifts tfit - tfit[0],
    train-r1.py:487).  restarts=0 is the reference behaviour (one fmin call,
    train-r1.py:490); restarts>0 re-launches Nelder-Mead from the incumbent
    until the residual stops improving — used when the target is known to lie
    exactly on the exp manifold (the cache-refit parity path), where a single
    default-budget fmin can stall short of the optimum on 7 parameters."""
    f = tri_exp if kind == "tri" else bi_exp
    x0 = x0 if x0 is not None else (X0_TRI if kind == "tri" else X0_BI)

    def rms(x):
        return float(np.sqrt(np.mean((f(t, x) - a) ** 2)))

    if use_cma:
        xopt, _ = cma_fmin(rms, x0, max_iter=max_iter)
    else:
        xopt = optimize.fmin(rms, x0, disp=False)
    best = rms(xopt)
    for _ in range(restarts):
        xnew = optimize.fmin(rms, xopt, disp=False)
        rnew = rms(xnew)
        if rnew < best:
            xopt, prev, best = xnew, best, rnew
            if best > 0.999 * prev:
                break
        else:
            break
    return np.asarray(xopt)


def _varpro_design(t: np.ndarray, rates) -> np.ndarray:
    """[n, n_rates+1] design matrix with overflow-clipped exponentials —
    rates carry free signs (a reference fit can land on a mildly NEGATIVE
    rate: a growing component over a short segment)."""
    cols = [np.exp(np.clip(-ri * t, -700.0, 60.0)) for ri in rates]
    cols.append(np.ones_like(t))
    return np.stack(cols, axis=1)


def _varpro_solve(t: np.ndarray, a: np.ndarray, rates):
    """Exact least-squares amplitudes for fixed rates; returns (rms,
    full param vector in fit_exp layout)."""
    m = _varpro_design(t, rates)
    amp, *_ = np.linalg.lstsq(m, a, rcond=None)
    rms = float(np.sqrt(np.mean((m @ amp - a) ** 2)))
    n_r = len(rates)
    x = np.empty(2 * n_r + 1)
    x[0:-1:2] = amp[:-1]
    x[1:-1:2] = rates
    x[-1] = amp[-1]
    return rms, x


def _varpro_polish(t: np.ndarray, a: np.ndarray, rates0, rounds: int = 3):
    """Variable-projection minimisation: Nelder-Mead over the rates only,
    amplitudes solved exactly inside the objective.  The amplitude subspace
    is linear, so the outer search is 2-3 dimensional — far more robust
    than the reference's full 7-parameter Nelder-Mead (train-r1.py:490)."""
    t_span = max(float(np.max(t)) - float(np.min(t)), 1e-9)

    def rms(r):
        res = _varpro_solve(t, a, r)[0]
        # soft barrier against absurd growth rates
        if np.max(r * -t_span) > 59.0:
            res += 1e3
        return res

    r = np.asarray(rates0, np.float64).copy()
    best = rms(r)
    for _ in range(rounds):
        rnew = optimize.fmin(rms, r, disp=False)
        resnew = rms(rnew)
        if resnew < best * (1.0 - 1e-3):
            r, best = rnew, resnew
        else:
            break
    return _varpro_solve(t, a, r)


def fit_exp_varpro(t: np.ndarray, a: np.ndarray, kind: str = "tri",
                   x0: np.ndarray | None = None, restarts: int = 6):
    """Variable-projection exp fit from the reference initial guess.
    Returns params in the same [a, b, c, d, (e, f,) g] layout as fit_exp."""
    x0 = x0 if x0 is not None else (X0_TRI if kind == "tri" else X0_BI)
    return _varpro_polish(t, a, np.asarray(x0[1:-1:2], np.float64),
                          rounds=1 + restarts)[1]


def fit_exp_ls(t: np.ndarray, a: np.ndarray, kind: str = "tri",
               x0: np.ndarray | None = None, n_starts: int = 16,
               rms_tol: float = 1e-10, seed: int = 0):
    """Deterministic three-stage exp fit: grid-seed -> varpro -> LM polish.

    1. Rank candidate rate tuples from a coarse log-grid over the segment's
       timescale, amplitudes solved exactly by lstsq (the model is LINEAR
       in them).
    2. Variable-projection Nelder-Mead over the rates from the best seeds.
    3. Full-parameter Levenberg-Marquardt polish of the incumbents.

    Every archived r1/r2 exp segment is recovered to ~1e-13 rms by this
    (the reference's single 7-parameter Nelder-Mead, train-r1.py:490,
    stalls on several).  Used by the cache-refit parity path and available
    as a stronger optimiser for fresh real-data fits."""
    from itertools import combinations

    from scipy.optimize import least_squares

    f = tri_exp if kind == "tri" else bi_exp
    x0 = np.asarray(x0 if x0 is not None
                    else (X0_TRI if kind == "tri" else X0_BI), np.float64)

    def resid(x):
        return _clipped_eval(f, t, x) - a

    n_r = len(x0) // 2
    t_span = max(float(np.max(t)) - float(np.min(t)), 1e-9)
    r_grid = np.array([0.25, 0.8, 2.5, 8.0, 25.0, 80.0]) / t_span
    rate_seeds = [np.asarray(c) for c in combinations(r_grid, n_r)]
    rate_seeds.append(np.asarray(x0[1:-1:2], np.float64))
    cands = sorted((_varpro_solve(t, a, r) for r in rate_seeds),
                   key=lambda c: c[0])
    n_polish = max(2, min(len(cands), n_starts // 3))
    polish_rates = [x[1:-1:2] for _, x in cands[:n_polish]]
    # always polish from the reference x0 rates too — on two archived r1
    # segments that basin is the right one yet its lstsq seed ranks low
    polish_rates.append(np.asarray(x0[1:-1:2], np.float64))
    polished = [_varpro_polish(t, a, r) for r in polish_rates]
    polished.sort(key=lambda c: c[0])
    best_x, best_rms = None, np.inf
    for trial, (_, xs) in enumerate(polished + [(None, x0)]):
        try:
            r = least_squares(resid, xs, method="lm", max_nfev=3000)
        except Exception:
            continue
        rm = float(np.sqrt(np.mean(r.fun ** 2)))
        if rm < best_rms:
            best_x, best_rms = r.x, rm
        if best_rms < max(rms_tol, 1e-9 * float(np.std(a))):
            break
    if best_x is None:  # pragma: no cover - LM never raises on finite data
        return np.asarray(x0)
    return np.asarray(best_x)


def _clipped_eval(f, t, x):
    """Evaluate tri/bi_exp with overflow-clipped exponents (rates are free
    signs during LM search; segments span up to ~1e4 ms)."""
    with np.errstate(over="ignore"):
        out = f(t, x)
    return np.nan_to_num(out, posinf=1e30, neginf=-1e30)


def eval_exp(kind: str, t: np.ndarray, x: np.ndarray):
    """(a, da/dt, d2a/dt2) for a fitted segment."""
    if kind == "tri":
        return tri_exp(t, x), dtri_exp(t, x), d2tri_exp(t, x)
    return bi_exp(t, x), dbi_exp(t, x), d2bi_exp(t, x)
