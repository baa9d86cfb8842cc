"""Exact analytic propagation on piecewise-constant voltage protocols
(counterpart of ``ionflux/solver/analytic.py``).

The candidate HH gates are two scalar linear ODEs within each
constant-voltage segment, ``x(t) = x_inf + (x0 - x_inf) exp(-s t)``, and the
3-state Markov model is ``dy/dt = A(V) y`` with a constant 6x6 generator per
segment, ``y(t) = expm(A t) y0``.  This module propagates both exactly on
the protocol's knot lattice: one affine map (HH) or one 6x6 matrix (Markov)
per knot interval, composed into prefix solutions.  Interval voltages use
the midpoint rule over ``ramp_subdiv`` slices per interval: exact inside
constant segments, 2nd-order across the one-knot ramp at each step edge.

The prefix compositions are JAX's ``lax.associative_scan`` tree (the
recursive odd/even scan: log2 N levels of torch ops, no per-interval loop),
so the two packages combine the same pairs in the same order; they differ
where the elementwise exponentials and the 6x6 products round differently
(tests/test_torch_analytic.py states the bounds).

``hh_solve_analytic_seg`` makes no host read: the segment structure
(``hh_segments``, numpy) is uploaded once per device, so a caller can
capture it in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from ionflux_torch.models.registry import HHParams, MarkovParams

__all__ = [
    "hh_solve_analytic",
    "hh_segments",
    "hh_solve_analytic_seg",
    "markov_solve_analytic",
    "markov_interval_propagators",
]


def _hh_p8(p, like: torch.Tensor) -> torch.Tensor:
    """HHParams | tensor [..., 8] -> tensor [..., 8] on ``like``'s device."""
    if isinstance(p, HHParams):
        return torch.tensor([float(x) for x in p], dtype=torch.float32,
                            device=like.device)
    return torch.as_tensor(p, device=like.device)


def _affine_combine(a, b):
    """Compose affine maps x -> alpha x + beta; ``a`` acts first."""
    aa, ba = a
    ab, bb = b
    return aa * ab, ba * ab + bb


def _prefix_scan(combine, elems, dim: int):
    """Inclusive prefix composition along ``dim`` (element 0 acts first):
    the recursive odd/even scan of ``jax.lax.associative_scan``, the same
    tree of combinations in torch ops (log2 N levels, O(N) work, no
    per-element loop)."""
    elems = tuple(x.movedim(dim, 0) for x in elems)
    return tuple(x.movedim(0, dim) for x in _scan0(combine, elems))


def _scan0(combine, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = _scan0(combine, combine(tuple(x[0:-1:2] for x in elems),
                                  tuple(x[1::2] for x in elems)))
    if n % 2 == 0:
        even = combine(tuple(x[:-1] for x in odd),
                       tuple(x[2::2] for x in elems))
    else:
        even = combine(odd, tuple(x[2::2] for x in elems))
    out = []
    for x, e, o in zip(elems, even, odd):
        y = x.new_empty(x.shape)
        y[0] = x[0]
        y[2::2] = e
        y[1::2] = o
        out.append(y)
    return tuple(out)


def _expm1_accurate(x: torch.Tensor) -> torch.Tensor:
    """expm1 to ~1 ulp: an 8-term Horner series for |x| < 0.5 (exact to
    ~1e-8 relative in exact arithmetic), exp(x) - 1 beyond, where it has no
    cancellation.  Kept as the reference computes it (not ``torch.expm1``),
    so the two packages' parity stays tight."""
    small = torch.abs(x) < 0.5
    xs = torch.where(small, x, torch.zeros_like(x))
    series = xs
    for k in range(8, 1, -1):
        series = xs * (1.0 + series / k)
    return torch.where(small, series, torch.exp(x) - 1.0)


def _rates(p8: torch.Tensor, vmid: torch.Tensor):
    """(s [..., M, 2], xinf [..., M, 2]) at voltages vmid [M]."""
    pe = p8.unsqueeze(-2)                   # broadcast params over intervals
    k1 = pe[..., 0] * torch.exp(pe[..., 1] * vmid)
    k2 = pe[..., 2] * torch.exp(-pe[..., 3] * vmid)
    k3 = pe[..., 4] * torch.exp(pe[..., 5] * vmid)
    k4 = pe[..., 6] * torch.exp(-pe[..., 7] * vmid)
    s = torch.stack([k1 + k2, k3 + k4], dim=-1)
    xinf = torch.stack([k1, k4], dim=-1) / s
    return s, xinf


def _hh_interval_maps(p8: torch.Tensor, vmid: torch.Tensor, dt):
    """Affine maps (alpha, beta) ``[..., N-1, 2]`` of one constant-voltage
    sub-interval of length ``dt`` at voltages ``vmid [N-1]``."""
    s, xinf = _rates(p8, vmid)
    em1 = _expm1_accurate(-s * dt)
    return 1.0 + em1, -xinf * em1


def _sub_voltages(v: torch.Tensor, subdiv: int) -> torch.Tensor:
    """Midpoint voltages of ``subdiv`` uniform slices of each knot interval:
    ``[subdiv, N-1]``."""
    w = (torch.arange(subdiv, dtype=v.dtype, device=v.device) + 0.5) / subdiv
    return v[None, :-1] + w[:, None] * (v[1:] - v[:-1])[None]


def _y0(y0, shp, like: torch.Tensor) -> torch.Tensor:
    if y0 is None:
        y0 = torch.tensor([0.0, 1.0], dtype=like.dtype, device=like.device)
    return torch.as_tensor(y0, device=like.device).to(like.dtype).expand(
        shp + (2,))


def hh_solve_analytic(p, v: torch.Tensor, dt, y0: torch.Tensor | None = None,
                      ramp_subdiv: int = 4):
    """Exact HH [a, r] trajectory at the protocol knots.

    p: ``HHParams`` or tensor ``[..., 8]`` (k1..k4 as ``p1 e^{p2 V}``,
    ``p3 e^{-p4 V}``, ``p5 e^{p6 V}``, ``p7 e^{-p8 V}``); leading dims are
    population lanes.  v: ``[N]`` knot voltages on a uniform ``dt`` lattice.
    y0: ``[..., 2]`` initial ``[a, r]`` (default ``[0, 1]``); carry
    ``ys[..., -1, :]`` to chain sweeps.  Returns ``ys [..., N, 2]``."""
    p8 = _hh_p8(p, v)
    shp = tuple(p8.shape[:-1])
    vsub = _sub_voltages(v, ramp_subdiv)
    dt_k = torch.full((), dt, dtype=v.dtype, device=v.device) / ramp_subdiv
    alpha, beta = _hh_interval_maps(p8, vsub[0], dt_k)
    for j in range(1, ramp_subdiv):
        alpha, beta = _affine_combine(
            (alpha, beta), _hh_interval_maps(p8, vsub[j], dt_k))
    ca, cb = _prefix_scan(_affine_combine, (alpha, beta), dim=-2)
    y0 = _y0(y0, shp, ca)
    ys = ca * y0[..., None, :] + cb
    return torch.cat([y0[..., None, :], ys], dim=-2)


class HHSegments:
    """Static index structure of a piecewise-constant protocol's segments
    (numpy, the shape of the protocol and not its data: one instance serves
    every sweep of a family whose step timing agrees).  ``tensors(device)``
    uploads it once per device."""

    __slots__ = ("first", "length", "is_ramp", "g", "r", "n_segments",
                 "_on")

    def __init__(self, first, length, is_ramp, g, r):
        self.first = first        # [S] first interval index of segment
        self.length = length      # [S] interval count of segment
        self.is_ramp = is_ramp    # [S] bool: one-knot linear ramp
        self.g = g                # [N-1] segment id of interval i
        self.r = r                # [N-1] 1-based interval offset in segment
        self.n_segments = int(first.size)
        self._on = {}

    def tensors(self, device: torch.device):
        """(first, length, is_ramp, g, r) on ``device``, uploaded at the
        first call for that device."""
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(
                torch.as_tensor(np.asarray(x), device=device)
                for x in (self.first.astype(np.int64), self.length,
                          self.is_ramp, self.g.astype(np.int64), self.r))
        return self._on[key]


def hh_segments(v) -> HHSegments:
    """Segment structure of concrete knot voltages ``v`` ([N] one sweep, or
    [n_sweeps, N] a family: boundaries are the union over sweeps).  An
    interval is a ramp iff any sweep's voltage changes across it; maximal
    runs of non-ramp intervals form constant segments, every ramp interval
    its own singleton segment."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v)
    v2 = v[None] if v.ndim == 1 else v
    ramp_iv = (v2[:, 1:] != v2[:, :-1]).any(axis=0)        # [N-1]
    n_iv = ramp_iv.size
    starts = np.zeros(n_iv, bool)
    starts[0] = True
    starts |= ramp_iv
    starts[1:] |= ramp_iv[:-1]
    g = np.cumsum(starts).astype(np.int32) - 1              # [N-1]
    first = np.flatnonzero(starts).astype(np.int32)         # [S]
    length = np.diff(np.append(first, n_iv)).astype(np.int32)
    r = (np.arange(n_iv, dtype=np.int32) - first[g]) + 1    # [N-1], 1-based
    return HHSegments(first, length, ramp_iv[first], g, r)


def hh_solve_analytic_seg(p, v: torch.Tensor, dt,
                          y0: torch.Tensor | None = None,
                          seg: HHSegments | None = None,
                          ramp_subdiv: int = 4):
    """Exact HH [a, r] trajectory by segment-level closed forms: the prefix
    composition runs over the S per-segment affine maps only, and every knot is evaluated directly from its segment-start state with
    one expm1, ``y(t) = y_start + (y_start - x_inf) em1(-s t)``.  ``seg``
    from ``hh_segments`` (derived from ``v`` when None, a host read);
    ``v``'s values may differ from the array it was computed from as long
    as the segment timing matches.  Args otherwise as
    ``hh_solve_analytic``."""
    p8 = _hh_p8(p, v)
    shp = tuple(p8.shape[:-1])
    if seg is None:
        seg = hh_segments(v)
    first, length, ramp, g, r = seg.tensors(v.device)
    # torch.full, not torch.tensor: no host-to-device copy under a capture
    dtj = torch.full((), dt, dtype=v.dtype, device=v.device)

    def interval_maps(vmid, dt_iv):
        """Affine maps + (s, xinf) at voltages vmid [S] over dt_iv [S]."""
        s, xinf = _rates(p8, vmid)
        em1 = _expm1_accurate(-s * dt_iv[..., None])
        return (1.0 + em1, -xinf * em1), s, xinf

    length_dt = length.to(v.dtype) * dtj                    # [S]
    v_seg = torch.index_select(v, 0, first)                 # [S]
    # full-segment maps: constant segments in one closed form ...
    (alpha_c, beta_c), s_seg, xinf_seg = interval_maps(v_seg, length_dt)
    # ... ramp segments (singleton intervals) via subdivided midpoints
    w = (torch.arange(ramp_subdiv, dtype=v.dtype, device=v.device)
         + 0.5) / ramp_subdiv
    v_next = torch.index_select(v, 0, first + 1)
    dt_slice = (dtj / ramp_subdiv).expand(v_seg.shape)
    ab_r, _, _ = interval_maps(v_seg + w[0] * (v_next - v_seg), dt_slice)
    for j in range(1, ramp_subdiv):
        ab_j, _, _ = interval_maps(v_seg + w[j] * (v_next - v_seg),
                                   dt_slice)
        ab_r = _affine_combine(ab_r, ab_j)
    alpha_full = torch.where(ramp[:, None], ab_r[0], alpha_c)
    beta_full = torch.where(ramp[:, None], ab_r[1], beta_c)

    # segment-start states from the prefix composition over the S segments
    ca, cb = _prefix_scan(_affine_combine, (alpha_full, beta_full), dim=-2)
    y0 = _y0(y0, shp, ca)
    y_end = ca * y0[..., None, :] + cb                      # [.., S, 2]
    y_start = torch.cat([y0[..., None, :], y_end[..., :-1, :]], dim=-2)

    # direct per-knot evaluation from the segment-start state
    t_rel = r.to(v.dtype) * dtj                             # [N-1]
    s_g = torch.index_select(s_seg, -2, g)
    em1_k = _expm1_accurate(-s_g * t_rel[:, None])
    ramp_g = torch.index_select(ramp, 0, g)[:, None]
    a_k = torch.where(ramp_g, torch.index_select(alpha_full, -2, g),
                      1.0 + em1_k)
    b_k = torch.where(ramp_g, torch.index_select(beta_full, -2, g),
                      -torch.index_select(xinf_seg, -2, g) * em1_k)
    ys = a_k * torch.index_select(y_start, -2, g) + b_k
    return torch.cat([y0[..., None, :], ys], dim=-2)


def _markov_p12(p, like: torch.Tensor) -> torch.Tensor:
    if isinstance(p, MarkovParams):
        return torch.tensor([float(x) for x in p], dtype=torch.float32,
                            device=like.device)
    return torch.as_tensor(p, device=like.device)


def markov_generator(p, v: torch.Tensor) -> torch.Tensor:
    """6x6 generator A(V) of the 3-state Markov model, ``[..., 6, 6]`` over
    broadcast(params[..., 12], v[...]); columns sum to zero.  State order
    [c1, c2, i, ic1, ic2, o]."""
    p12 = _markov_p12(p, v)
    a1 = p12[..., 0] * torch.exp(p12[..., 1] * v)
    b1 = p12[..., 2] * torch.exp(-p12[..., 3] * v)
    bh = p12[..., 4] * torch.exp(p12[..., 5] * v)
    ah = p12[..., 6] * torch.exp(-p12[..., 7] * v)
    a2 = p12[..., 8] * torch.exp(p12[..., 9] * v)
    b2 = p12[..., 10] * torch.exp(-p12[..., 11] * v)
    z = torch.zeros_like(a1)
    rows = [
        [-(b1 + bh + a2), a1, z, ah, z, b2],
        [b1, -(a1 + bh), z, z, ah, z],
        [z, z, -(b2 + ah), a2, z, bh],
        [bh, z, b2, -(b1 + ah + a2), a1, z],
        [z, bh, z, b1, -(ah + a1), z],
        [a2, z, ah, z, z, -(b2 + bh)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _check_fp32_matmul(x: torch.Tensor) -> None:
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the Markov propagators are float32 products; "
                           "set torch.backends.cuda.matmul.allow_tf32 = "
                           "False")


def _matmul_combine(a, b):
    """Compose propagators; ``a`` acts first: combined = b @ a."""
    (ma,), (mb,) = a, b
    return (torch.matmul(mb, ma),)


def markov_interval_propagators(p, v: torch.Tensor, dt,
                                ramp_subdiv: int = 4) -> torch.Tensor:
    """``[N-1, 6, 6]`` exact interval propagators: the product of
    ``ramp_subdiv`` constant-voltage slice exponentials
    ``matrix_exp(A(v_slice) dt/k)``, in full float32 (TF32 off)."""
    _check_fp32_matmul(v)
    vsub = _sub_voltages(v, ramp_subdiv)
    dt_k = torch.full((), dt, dtype=v.dtype, device=v.device) / ramp_subdiv
    props = torch.linalg.matrix_exp(markov_generator(p, vsub[0]) * dt_k)
    for j in range(1, ramp_subdiv):
        props = torch.matmul(torch.linalg.matrix_exp(
            markov_generator(p, vsub[j]) * dt_k), props)
    return props


def markov_solve_analytic(p, v: torch.Tensor, dt,
                          y0: torch.Tensor | None = None,
                          ramp_subdiv: int = 4) -> torch.Tensor:
    """Exact 6-state Markov trajectory at the protocol knots.  p:
    ``MarkovParams`` or ``[12]``; v: ``[N]`` knot voltages on a uniform
    ``dt`` lattice; y0 ``[6]`` (default ``MARKOV_Y0_REST``, c2 = 1).
    Returns ``ys [N, 6]``."""
    props = markov_interval_propagators(p, v, dt, ramp_subdiv)  # [N-1,6,6]
    (cum,) = _prefix_scan(_matmul_combine, (props,), dim=0)
    if y0 is None:
        from ionflux_torch.models.markov import MARKOV_Y0_REST
        y0 = MARKOV_Y0_REST
    y0 = torch.as_tensor(y0, device=v.device).to(props.dtype)
    ys = torch.matmul(cum, y0)
    return torch.cat([y0[None], ys], dim=0)
