"""Cubic-spline interpolation and differentiation on uniform grids
(counterpart of ``ionflux/ops/spline.py``): the interpolating spline's
derivative at the knots, as the reference takes it from FITPACK's
``UnivariateSpline(..., s=0).derivative()``, computed on the device.

Boundary condition: not-a-knot (FITPACK's s = 0 behaviour); natural is also
provided.  The tridiagonal systems are solved by the Thomas algorithm:
``tridiag_solve_batched`` takes a batch of systems packed one after another
(the segments of a protocol) and sends a CPU tensor to the plain PyTorch
loop (``tridiag_solve_batched_plain``) and a CUDA tensor to the kernel K1 in
``csrc/tridiag.cu`` (one thread per system, one launch for the batch);
``tridiag_solve_batched.launches`` counts kernel launches.  Both round every
product and sum on its own in the reference's order.
"""

from __future__ import annotations

import torch

from ionflux_torch.ops._build import count_launch


def _check(xs, lengths) -> None:
    n = xs[0].shape[0]
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            raise TypeError("the Thomas solve takes float32 tensors")
        if x.dim() != 1 or x.shape[0] != n or x.device != xs[0].device:
            raise ValueError("dl, d, du, b must be [total] on one device")
    if sum(lengths) != n or min(lengths) < 1:
        raise ValueError(f"lengths {lengths} do not tile {n} rows")


def _starts(lengths, device):
    lengths = [int(k) for k in lengths]
    starts = [0]
    for k in lengths[:-1]:
        starts.append(starts[-1] + k)
    return (torch.tensor(starts, dtype=torch.int64, device=device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def tridiag_solve_batched_plain(dl, d, du, b, lengths) -> torch.Tensor:
    """The Thomas recurrences in PyTorch ops: every system of the batch
    advanced together one row at a time (a host loop over the longest
    system's rows; a system that has ended keeps its values)."""
    _check((dl, d, du, b), lengths)
    start, length = _starts(lengths, b.device)
    last = start + length.to(torch.int64) - 1
    cp, dp, x = (torch.zeros_like(b) for _ in range(3))
    c = du[start] / d[start]
    e = b[start] / d[start]
    cp[start] = c
    dp[start] = e
    for j in range(1, max(int(k) for k in lengths)):
        live = j < length
        k = torch.minimum(start + j, last)
        l_ = dl[k]
        den = d[k] - l_ * c
        c = torch.where(live, du[k] / den, c)
        e = torch.where(live, (b[k] - l_ * e) / den, e)
        cp[k] = torch.where(live, c, cp[k])
        dp[k] = torch.where(live, e, dp[k])
    xn = dp[last]
    x[last] = xn
    for j in range(max(int(k) for k in lengths) - 2, -1, -1):
        live = j <= length - 2
        k = torch.where(live, start + j, last)
        xn = torch.where(live, dp[k] - cp[k] * xn, xn)
        x[k] = torch.where(live, xn, x[k])
    return x


def tridiag_solve_batched(dl, d, du, b, lengths) -> torch.Tensor:
    """x of a batch of tridiagonal systems packed in dl, d, du, b [total]
    float32 (system i: ``lengths[i]`` rows after the systems before it;
    dl[0] and du[-1] of each system unused).  CUDA tensors run K1 (one
    thread per system, no host read once the lengths are uploaded); CPU
    tensors run ``tridiag_solve_batched_plain``."""
    if not b.is_cuda:
        return tridiag_solve_batched_plain(dl, d, du, b, lengths)
    _check((dl, d, du, b), lengths)
    from ionflux_torch.ops._build import launch

    dl, d, du, b = (x.contiguous() for x in (dl, d, du, b))
    start, length = _starts(lengths, b.device)
    x, cp, dp = (torch.empty_like(b) for _ in range(3))
    launch("tridiag", "ionflux_thomas", b.device, dl.data_ptr(),
           d.data_ptr(), du.data_ptr(), b.data_ptr(), x.data_ptr(),
           cp.data_ptr(), dp.data_ptr(), start.data_ptr(),
           length.data_ptr(), len(lengths))
    count_launch(tridiag_solve_batched)
    return x


tridiag_solve_batched.launches = 0


def tridiag_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Thomas algorithm for one tridiagonal system.  dl: [n] sub-diagonal
    (dl[0] unused), d: [n] diagonal, du: [n] super-diagonal (du[-1]
    unused), b: [n] right-hand side or [n, k] (k systems with one
    matrix)."""
    dtype = torch.promote_types(torch.promote_types(dl.dtype, d.dtype),
                                torch.promote_types(du.dtype, b.dtype))
    if dtype != torch.float32:
        raise TypeError("tridiag_solve is float32")
    n = b.shape[0]
    if b.dim() == 1:
        return tridiag_solve_batched(dl, d, du, b, [n])
    k = b.shape[1]
    rep = lambda x: x.repeat(k)  # noqa: E731
    x = tridiag_solve_batched(rep(dl), rep(d), rep(du),
                              b.T.reshape(-1).contiguous(), [n] * k)
    return x.reshape(k, n).T


def _m_from_rhs(rhs_in: torch.Tensor, bc: str):
    """(the tridiagonal unknowns' right-hand side, how to assemble M from
    their solution) of one spline's interior second differences."""
    if bc == "natural":
        return rhs_in, lambda m_in: torch.cat(
            [rhs_in.new_zeros(1), m_in, rhs_in.new_zeros(1)])
    if bc != "not-a-knot":
        raise ValueError(f"unknown boundary condition {bc!r}")
    # not-a-knot: M0 = 2 M1 - M2 and Mn-1 = 2 Mn-2 - Mn-3; substituted into
    # the first and last interior rows they give 6 M1 = rhs[0] and
    # 6 Mn-2 = rhs[-1], leaving a tridiagonal for M2..Mn-3
    m1 = rhs_in[0] / 6.0
    mm2 = rhs_in[-1] / 6.0

    def assemble(m_mid):
        if m_mid is None:
            m = torch.stack([m1, mm2])
        else:
            m = torch.cat([m1[None], m_mid, mm2[None]])
        m0 = 2.0 * m[0] - m[1]
        mn = 2.0 * m[-1] - m[-2]
        return torch.cat([m0[None], m, mn[None]])

    if rhs_in.shape[0] <= 2:
        return None, assemble
    rhs_mid = rhs_in[1:-1].clone()
    rhs_mid[0] = rhs_mid[0] + (-m1)
    rhs_mid[-1] = rhs_mid[-1] + (-mm2)
    return rhs_mid, assemble


def _second_differences(y: torch.Tensor, h) -> torch.Tensor:
    h = torch.full((), h, dtype=y.dtype, device=y.device)
    return 6.0 / (h * h) * (y[:-2] - 2.0 * y[1:-1] + y[2:])


def _spline_systems(ys, h, bc: str):
    """The splines' tridiagonal systems packed for one Thomas call: (dl, d,
    du, b, lengths), None if no spline needs one, and how to assemble each
    spline's M from the packed solution."""
    rhs, assembles = [], []
    for y in ys:
        r, assemble = _m_from_rhs(_second_differences(y, h), bc)
        rhs.append(r)
        assembles.append(assemble)
    solve = [r for r in rhs if r is not None]
    lengths = [r.shape[0] for r in solve]

    def assemble_all(x):
        sols = iter(torch.split(x, lengths) if lengths else [])
        return [assemble(None if r is None else next(sols))
                for r, assemble in zip(rhs, assembles)]

    if not solve:
        return None, assemble_all
    b = torch.cat(solve)
    ones = torch.ones_like(b)
    return (ones, torch.full_like(b, 4.0), ones, b, lengths), assemble_all


def cubic_spline_m_segments(ys, h, bc: str = "not-a-knot"):
    """Second derivatives M of the interpolating cubic spline through each
    of ``ys`` (a list of [n_i] tensors, n_i >= 4, on one uniform step h),
    with ONE Thomas launch for all of them."""
    system, assemble_all = _spline_systems(ys, h, bc)
    x = None if system is None else tridiag_solve_batched(*system)
    return assemble_all(x)


def cubic_spline_m(y: torch.Tensor, h, bc: str = "not-a-knot") -> torch.Tensor:
    """Second derivatives M[i] of the interpolating cubic spline through
    (i*h, y[i]).  bc: 'not-a-knot' | 'natural'."""
    return cubic_spline_m_segments([y], h, bc)[0]


def _derivative(y: torch.Tensor, m: torch.Tensor, h) -> torch.Tensor:
    h = torch.full((), h, dtype=y.dtype, device=y.device)
    # the right derivative at each interval start; the left one at the end
    d_fwd = (y[1:] - y[:-1]) / h - h / 6.0 * (2.0 * m[:-1] + m[1:])
    d_last = (y[-1] - y[-2]) / h + h / 6.0 * (2.0 * m[-1] + m[-2])
    return torch.cat([d_fwd, d_last[None]])


def spline_derivative_segments(ys, h, bc: str = "not-a-knot"):
    """dy/dx at the knots of each spline through ``ys`` (list of [n_i]),
    one Thomas launch for all."""
    ms = cubic_spline_m_segments(ys, h, bc)
    return [_derivative(y, m, h) for y, m in zip(ys, ms)]


def spline_derivative(y: torch.Tensor, h,
                      bc: str = "not-a-knot") -> torch.Tensor:
    """dy/dx of the interpolating cubic spline AT the knots (what the
    reference extracts with spl.derivative()(tfit))."""
    return spline_derivative_segments([y], h, bc)[0]
