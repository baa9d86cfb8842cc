"""CMA-ES whole-trace fitting (counterpart of ``ionflux/fit/cmaes.py``: the
host ``cmaes`` and the device-resident ``cmaes_onchip``; the reference's
PINTS path).

Reference usage: ``pints.OptimisationController`` with ``pints.CMAES``,
log-transform, rectangular bounds [0.1 p0, 10 p0], sigma0 = 0.1 p0, stop
after 100 unchanged iterations at threshold 1e-3.

The ask/tell covariance machinery (standard Hansen CMA-ES) runs host-side in
numpy float64 with ``np.random.default_rng(seed)``, O(n^2) with n = 4-9
parameters, while the population objective is one batch of whole-trace ODE
solves on the device.  Non-finite or diverged solves return inf and are
rejected by ranking.  The same seed and objective give the same iterates as
the reference package.

``cmaes_onchip`` runs the whole fit on the device: chunks of ``sync_every``
generations, each on the card one replay of a CUDA graph (draw, clip,
objective, ranking, the mean / path / covariance / step-size updates), with
one host read a chunk (the stop scalars) made while the next chunk runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ionflux_torch._device import resolve_device
from ionflux_torch.ops._build import Graph
from ionflux_torch.ops.sym_eig import sym_eig


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


def _normals(gen: torch.Generator, lam: int, n: int,
             device: torch.device) -> torch.Tensor:
    """One generation's standard normals [lam, n] float32 from ``gen`` (the
    streams differ from ``jax.random``'s; the tests feed both packages one
    table through this helper)."""
    return torch.randn((lam, n), generator=gen, dtype=torch.float32,
                       device=device)


def cmaes_onchip(
    objective_fn: Callable,
    x0: np.ndarray,
    sigma0: np.ndarray | float,
    bounds: tuple[np.ndarray, np.ndarray] | None = None,
    popsize: int | None = None,
    max_iterations: int | None = None,
    max_unchanged_iterations: int = 100,
    unchanged_threshold: float = 1e-3,
    log_transform: bool = True,
    seed: int = 0,
    sync_every: int = 8,
    device=None,
) -> CMAESResult:
    """Device-resident CMA-ES: ``objective_fn`` (xs [lam, n] float32 tensor
    in ORIGINAL space -> [lam] losses, inf for diverged candidates) and the
    whole strategy run on ``device`` in chunks of ``sync_every``
    generations.  On a CUDA device a chunk is captured once as a CUDA graph
    (after one eager generation on scratch copies warms up the objective
    and the kernels) and replayed, dispatched with one chunk of lookahead:
    each chunk's stop scalars (unchanged, iteration, best loss) are copied
    to pinned host memory while the next chunk runs, and that is the only
    host read.  ``objective_fn`` must then be capturable (no host read, no
    host-to-device copy).  On the CPU the chunks run eagerly.

    Constants, update order and stopping rule are ``cmaes``'s (Hansen 2016
    defaults), in float32, with the eigendecomposition by
    ``ops.sym_eig.sym_eig`` (Jacobi; no host read) and the normals from a
    ``torch.Generator`` seeded with ``seed``.  Each in-chunk generation
    freezes the state once a stopping rule fires, so the reported iteration
    count is exact; up to two chunks of frozen generations run past the
    stop.  ``history`` holds (iteration, best loss) at every chunk boundary
    from the start, as the reference's does."""
    device = resolve_device(device)
    f32 = torch.float32
    x0 = np.asarray(x0, np.float64)
    n = x0.size
    lam = popsize or _default_popsize(n)
    mu = lam // 2
    w_np = np.log(lam / 2 + 0.5) - np.log(np.arange(1, mu + 1))
    w_np /= w_np.sum()
    mueff = float(1.0 / np.sum(w_np ** 2))

    cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
    cs = (mueff + 2) / (n + mueff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mueff)
    cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff))
    damps = float(1 + 2 * max(0.0, np.sqrt((mueff - 1) / (n + 1)) - 1) + cs)
    chi_n = float(np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n ** 2)))
    ps_gain = float(np.sqrt(cs * (2 - cs) * mueff))
    pc_gain = float(np.sqrt(cc * (2 - cc) * mueff))

    sigma0 = np.asarray(sigma0, np.float64) * np.ones(n)
    if log_transform:
        if np.any(x0 <= 0):
            raise ValueError("log_transform requires positive x0")
        m0 = np.log(x0)
        sig_init = float(np.mean(sigma0 / x0))
        scale = None
    else:
        scale = np.where(sigma0 > 0, sigma0, 1.0)
        m0 = x0 / scale
        sig_init = 1.0
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("cmaes_onchip is float32; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")

    def dev(x, dtype=f32):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    lo_t = hi_t = None
    if bounds is not None:
        lo_np, hi_np = (np.asarray(b, np.float64) for b in bounds)
        lo_t = dev(np.log(lo_np) if log_transform else lo_np / scale)
        hi_t = dev(np.log(hi_np) if log_transform else hi_np / scale)
    w = dev(w_np)
    scale_t = None if scale is None else dev(scale)
    decay = torch.full((), 1 - cs, dtype=f32, device=device)
    inf = torch.full((), float("inf"), dtype=f32, device=device)
    max_it_eff = 1_000_000 if max_iterations is None else max_iterations

    def step(c, gen):
        m, sigma, cov, p_c, p_s, best_x, best_f, unchanged, it = c
        it = it + 1
        d2, b_mat = sym_eig(cov)
        d = torch.sqrt(torch.clamp(d2, min=1e-20))
        inv_sqrt_c = (b_mat * (1.0 / d)[None, :]) @ b_mat.T

        z = _normals(gen, lam, n, device)
        y = (z * d[None, :]) @ b_mat.T
        xs_t = m[None, :] + sigma * y
        if lo_t is not None:
            xs_t = torch.minimum(torch.maximum(xs_t, lo_t), hi_t)
            y = (xs_t - m[None, :]) / sigma
        xs = torch.exp(xs_t) if log_transform else xs_t * scale_t

        fs = objective_fn(xs).reshape(lam)
        fs = torch.where(torch.isfinite(fs), fs, inf)
        # index_select, not fs[order[0]]: a 0-d index is read on the host
        order = torch.argsort(fs, stable=True)
        f_min = torch.index_select(fs, 0, order[:1])[0]
        improved = (best_f - f_min) > unchanged_threshold
        best_x = torch.where(f_min < best_f,
                             torch.index_select(xs, 0, order[:1])[0], best_x)
        best_f = torch.minimum(best_f, f_min)
        unchanged = torch.where(improved, torch.zeros_like(unchanged),
                                unchanged + 1)

        y_mu = torch.index_select(y, 0, order[:mu])
        y_w = w @ y_mu
        m = m + sigma * y_w
        p_s = (1 - cs) * p_s + ps_gain * (inv_sqrt_c @ y_w)
        norm_ps = torch.linalg.vector_norm(p_s)
        denom = torch.sqrt(1 - torch.pow(decay, 2 * it.to(f32)))
        h_sig = ((norm_ps / denom / chi_n) < (1.4 + 2 / (n + 1))).to(f32)
        p_c = (1 - cc) * p_c + h_sig * pc_gain * y_w
        cov = ((1 - c1 - cmu) * cov
               + c1 * (torch.outer(p_c, p_c)
                       + (1 - h_sig) * cc * (2 - cc) * cov)
               + cmu * (y_mu.T * w[None, :]) @ y_mu)
        sigma = sigma * torch.exp((cs / damps) * (norm_ps / chi_n - 1))
        sigma = torch.clamp(sigma, 1e-12, 1e6)
        return (m, sigma, cov, p_c, p_s, best_x, best_f, unchanged, it)

    def chunk(c, gen, stats):
        """sync_every generations, each frozen once a stopping rule fires;
        the carry c updated in place, its stop scalars into stats."""
        for _ in range(sync_every):
            unchanged, it = c[-2], c[-1]
            done = (it >= max_it_eff) | (unchanged >= max_unchanged_iterations)
            new = step(c, gen)
            for dst, src in zip(c, new):
                dst.copy_(torch.where(done, dst, src))
        stats.copy_(torch.stack([c[7].double(), c[8].double(),
                                 c[6].double()]))

    def fresh():
        return [dev(m0), torch.full((), sig_init, dtype=f32, device=device),
                torch.eye(n, dtype=f32, device=device),
                torch.zeros(n, dtype=f32, device=device),
                torch.zeros(n, dtype=f32, device=device), dev(x0),
                inf.clone(), torch.zeros((), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device)]

    def stop(unchanged, it) -> bool:
        return it >= max_it_eff or unchanged >= max_unchanged_iterations

    carry = fresh()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stats = torch.zeros(3, dtype=torch.float64, device=device)
    history = [(0, float("inf"))]
    max_chunks = -(-max_it_eff // sync_every) + 2
    if stop(0, 0):
        pass
    elif device.type != "cuda":
        for _ in range(max_chunks):
            chunk(carry, gen, stats)
            unchanged, it, best = stats.tolist()
            history.append((int(it), best))
            if stop(unchanged, it):
                break
    else:
        # warm up the objective and the kernels on scratch copies, with a
        # scratch generator, then capture one chunk on the real state
        scratch = torch.Generator(device=device)
        scratch.manual_seed(seed + 1)
        step(fresh(), scratch)
        torch.cuda.synchronize(device)
        try:
            graph = Graph(chunk, carry, gen, stats, generators=(gen,))
        except RuntimeError as exc:
            raise RuntimeError(
                "cmaes_onchip: capturing a chunk of generations as a CUDA "
                "graph failed; the objective must make no host read or "
                f"host-to-device copy ({exc})") from exc
        pinned = [torch.zeros(3, dtype=torch.float64).pin_memory()
                  for _ in range(2)]
        ready = [torch.cuda.Event(), torch.cuda.Event()]
        graph.replay()
        pinned[0].copy_(stats, non_blocking=True)
        ready[0].record()
        i = 0
        for _ in range(max_chunks):
            graph.replay()                       # the lookahead chunk
            pinned[1 - i].copy_(stats, non_blocking=True)
            ready[1 - i].record()
            ready[i].synchronize()
            unchanged, it, best = pinned[i].tolist()
            history.append((int(it), best))
            if stop(unchanged, it):
                break
            i = 1 - i
        torch.cuda.synchronize(device)

    best_x, best_f = carry[5], carry[6]
    it, unchanged = int(carry[8]), int(carry[7])
    if history[-1][0] != it:
        history.append((it, float(best_f)))
    hit_max = (max_iterations is not None and it >= max_iterations
               and unchanged < max_unchanged_iterations)
    if hit_max:
        print(f"cmaes_onchip: stopped at max_iterations={max_iterations} "
              f"before convergence (unchanged={unchanged}/"
              f"{max_unchanged_iterations})")
    return CMAESResult(x=best_x.double().cpu().numpy(),
                       fx=float(best_f), iterations=it,
                       evaluations=it * lam, history=history,
                       hit_max_iterations=hit_max)


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
