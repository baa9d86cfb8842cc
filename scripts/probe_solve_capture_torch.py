#!/usr/bin/env python
"""Which small linear solves survive a CUDA-graph capture on the card: the
choice behind ``ionflux_torch/solver/implicit.py``'s unrolled LU.

    python3 scripts/probe_solve_capture_torch.py

For a 2 x 2 and a 6 x 6 system (the HH and Markov Rosenbrock steps), each
way of solving (``torch.linalg.solve``, ``solve_ex(check_errors=False)``,
``lu_factor_ex(check_errors=False)`` + ``lu_solve``, which the solver
uses, and an LU with partial pivoting unrolled in tensor ops) is
run eagerly, then captured and replayed on new values: one JSON line each
with whether the capture held, the replay's largest difference from the
eager solve of the same values, and the eager and replayed microseconds
per solve (CUDA events over 200 calls or replays).  Each way runs in a
process of its own: a capture that fails can leave the context unusable.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

REPS = 200


def _lu(a: torch.Tensor):
    """LU with partial pivoting in tensor ops, no host read: (lu, perm)
    with a[perm] = L U, L unit-lower and U packed in lu."""
    n = a.shape[0]
    a = a.clone()
    rows = torch.arange(n, device=a.device)
    perm = rows.clone()
    for k in range(n - 1):
        p = k + torch.argmax(torch.abs(a[k:, k]))
        swap = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        a = a.index_select(0, swap)
        perm = perm.index_select(0, swap)
        piv = a[k + 1:, k] * (1.0 / a[k, k])
        a[k + 1:, k + 1:] -= piv[:, None] * a[k, k + 1:][None, :]
        a[k + 1:, k] = piv
    return a, perm


def _lu_solve(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor):
    n = lu.shape[0]
    b = b.index_select(0, perm)
    z = []
    for i in range(n):
        z.append(b[i] - torch.dot(lu[i, :i], torch.stack(z)) if i else b[i])
    x = [None] * n
    for i in reversed(range(n)):
        xi = z[i]
        if i < n - 1:
            xi = xi - torch.dot(lu[i, i + 1:], torch.stack(x[i + 1:]))
        x[i] = xi / lu[i, i]
    return torch.stack(x)


def _ways():
    def unrolled(a, b):
        lu, perm = _lu(a)
        return _lu_solve(lu, perm, b)

    def lu_ex(a, b):
        lu, piv, _ = torch.linalg.lu_factor_ex(a, check_errors=False)
        return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]

    return {"linalg.solve": torch.linalg.solve,
            "linalg.solve_ex": lambda a, b: torch.linalg.solve_ex(
                a, b, check_errors=False)[0],
            "lu_factor_ex+lu_solve": lu_ex,
            "unrolled LU": unrolled}


def _us(fn) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / REPS


def probe(name: str) -> None:
    """The rows of one way of solving, at both sizes."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    solve = _ways()[name]
    for n in (2, 6):
        a = torch.eye(n, device=dev) + 0.3 * torch.randn(
            n, n, device=dev, generator=gen)
        b = torch.randn(n, device=dev, generator=gen)
        row = {"n": n, "solve": name}
        try:
            row["eager_us"] = _us(lambda: solve(a, b))
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                solve(a, b)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                out = solve(a, b)
            a.copy_(torch.eye(n, device=dev) + 0.3 * torch.randn(
                n, n, device=dev, generator=gen))
            b.copy_(torch.randn(n, device=dev, generator=gen))
            graph.replay()
            want = solve(a, b)
            row["captured"] = True
            row["replay_max_abs_diff"] = float((out - want).abs().max())
            row["replay_us"] = _us(graph.replay)
        except RuntimeError as exc:
            row["captured"] = False
            row["error"] = str(exc).splitlines()[0][:200]
            torch.cuda.synchronize()
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("probe_solve_capture: needs a CUDA device", file=sys.stderr)
        return 2
    if argv:
        probe(argv[0])
        return 0
    for name in _ways():
        subprocess.run([sys.executable, os.path.abspath(__file__), name],
                       check=False, timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
