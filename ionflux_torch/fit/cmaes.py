"""CMA-ES whole-trace fitting (counterpart of the host half of
``ionflux/fit/cmaes.py``; the reference's PINTS path).

Reference usage: ``pints.OptimisationController`` with ``pints.CMAES``,
log-transform, rectangular bounds [0.1 p0, 10 p0], sigma0 = 0.1 p0, stop
after 100 unchanged iterations at threshold 1e-3.

The ask/tell covariance machinery (standard Hansen CMA-ES) runs host-side in
numpy float64 with ``np.random.default_rng(seed)``, O(n^2) with n = 4-9
parameters, while the population objective is one batch of whole-trace ODE
solves on the device.  Non-finite or diverged solves return inf and are
rejected by ranking.  The same seed and objective give the same iterates as
the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class CMAESResult:
    x: np.ndarray              # best parameters (original space)
    fx: float                  # best objective value
    iterations: int
    evaluations: int
    history: list = field(default_factory=list)  # (iter, best_fx)
    # True when the fit stopped on max_iterations rather than convergence
    # (the unchanged-iterations rule): a silently truncated fit is the one
    # outcome a caller must be able to see
    hit_max_iterations: bool = False


def _default_popsize(n: int) -> int:
    return 4 + int(3 * np.log(n))


def cmaes(
    objective_batch: Callable[[np.ndarray], np.ndarray],
    x0: np.ndarray,
    sigma0: np.ndarray | float,
    bounds: tuple[np.ndarray, np.ndarray] | None = None,
    popsize: int | None = None,
    max_iterations: int | None = None,
    max_unchanged_iterations: int = 100,
    unchanged_threshold: float = 1e-3,
    log_transform: bool = True,
    seed: int = 0,
    verbose: bool = False,
) -> CMAESResult:
    """Minimize objective_batch([pop, n] params in ORIGINAL space) -> [pop].

    Mirrors the reference's controller semantics: sigma0/bounds given in
    original space; optimization runs in log space when log_transform
    (pints.LogTransformation).
    """
    x0 = np.asarray(x0, np.float64)
    n = x0.size
    lam = popsize or _default_popsize(n)
    mu = lam // 2
    w = np.log(lam / 2 + 0.5) - np.log(np.arange(1, mu + 1))
    w /= w.sum()
    mueff = 1.0 / np.sum(w ** 2)

    # strategy constants (Hansen 2016 tutorial defaults)
    cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
    cs = (mueff + 2) / (n + mueff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mueff)
    cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff))
    damps = 1 + 2 * max(0.0, np.sqrt((mueff - 1) / (n + 1)) - 1) + cs
    chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n ** 2))

    sigma0 = np.asarray(sigma0, np.float64) * np.ones(n)
    if log_transform:
        to_t = np.log
        from_t = np.exp
        # sigma in log space: the original-space spread through the local
        # log-derivative at x0
        sigma = float(np.mean(sigma0 / x0))
    else:
        # per-dimension coordinate scaling so one scalar sigma serves
        # parameters of wildly different magnitudes
        scale = np.where(sigma0 > 0, sigma0, 1.0)
        to_t = lambda z: np.asarray(z, np.float64) / scale  # noqa: E731
        from_t = lambda z: z * scale  # noqa: E731
        sigma = 1.0

    m = to_t(x0)

    if bounds is not None:
        lo, hi = (to_t(np.asarray(b, np.float64)) for b in bounds)
    else:
        lo = hi = None

    cov = np.eye(n)
    p_c = np.zeros(n)
    p_s = np.zeros(n)
    rng = np.random.default_rng(seed)

    best_x, best_f = x0.copy(), np.inf
    unchanged = 0
    evals = 0
    history = []
    it = 0
    while True:
        it += 1
        d2, b_mat = np.linalg.eigh(cov)
        d = np.sqrt(np.maximum(d2, 1e-20))
        inv_sqrt_c = b_mat @ np.diag(1.0 / d) @ b_mat.T

        z = rng.standard_normal((lam, n))
        y = z @ np.diag(d) @ b_mat.T
        xs_t = m + sigma * y
        if lo is not None:
            xs_t = np.clip(xs_t, lo, hi)  # rectangular boundaries
            y = (xs_t - m) / sigma
        xs = from_t(xs_t)

        fs = np.asarray(objective_batch(xs), np.float64).reshape(lam)
        fs = np.where(np.isfinite(fs), fs, np.inf)
        evals += lam

        order = np.argsort(fs)
        if fs[order[0]] < best_f - 0:
            improved = best_f - fs[order[0]] > unchanged_threshold
            if fs[order[0]] < best_f:
                best_f = float(fs[order[0]])
                best_x = xs[order[0]].copy()
            unchanged = 0 if improved else unchanged + 1
        else:
            unchanged += 1
        history.append((it, best_f))
        if verbose and it % 20 == 0:
            print(f"cmaes iter {it} best {best_f:.6g} sigma {sigma:.3g}")

        y_w = w @ y[order[:mu]]
        m = m + sigma * y_w

        p_s = (1 - cs) * p_s + np.sqrt(cs * (2 - cs) * mueff) * (inv_sqrt_c @ y_w)
        h_sig = (np.linalg.norm(p_s)
                 / np.sqrt(1 - (1 - cs) ** (2 * it)) / chi_n) < 1.4 + 2 / (n + 1)
        p_c = (1 - cc) * p_c + h_sig * np.sqrt(cc * (2 - cc) * mueff) * y_w

        arts = y[order[:mu]]
        cov = ((1 - c1 - cmu) * cov
               + c1 * (np.outer(p_c, p_c) + (not h_sig) * cc * (2 - cc) * cov)
               + cmu * arts.T @ np.diag(w) @ arts)
        sigma *= np.exp((cs / damps) * (np.linalg.norm(p_s) / chi_n - 1))
        sigma = float(np.clip(sigma, 1e-12, 1e6))

        if max_iterations is not None and it >= max_iterations:
            break
        if unchanged >= max_unchanged_iterations:
            break
    return CMAESResult(x=best_x, fx=best_f, iterations=it,
                       evaluations=evals, history=history,
                       hit_max_iterations=(max_iterations is not None
                                           and it >= max_iterations
                                           and unchanged
                                           < max_unchanged_iterations))


def fmin(f: Callable[[np.ndarray], float], x0, sigma0=None, max_iter=None,
         **kw):
    """pints.fmin-style convenience wrapper around a scalar objective
    (used by the reference for hard tri-exp sub-fits)."""
    x0 = np.asarray(x0, np.float64)
    sigma0 = sigma0 if sigma0 is not None else np.abs(x0) * 0.1 + 1e-3

    def batch(xs):
        return np.array([f(x) for x in xs])

    res = cmaes(batch, x0, sigma0, max_iterations=max_iter,
                log_transform=False, **kw)
    return res.x, res.fx
