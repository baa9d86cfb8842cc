"""Fused DP5(4) solves of NN-f/NN-d gate models, for many lanes on one
shared step controller (counterpart of four kernels of
``ionflux/ops/pallas_solve.py``).

- ``fused_nnf_solve_ft`` (replaces ``pallas_solve.py::fused_nnf_solve_ft``):
  one shared MLP over B <= 128 protocols, from rest, no cull.
- ``fused_nnf_popsweep_solve_ft`` (replaces
  ``pallas_solve.py::fused_nnf_popsweep_solve_ft``): P member MLPs x Q
  protocols, with a y0 carry and the pace cull;
  ``fused_nnf_popsweep_chained`` chains it over the segments of long
  recordings.
- ``fused_nnf_pop_solve_ft`` (replaces
  ``pallas_solve.py::fused_nnf_pop_solve_ft``): P member MLPs on ONE shared
  protocol, from rest, no cull.
- ``fused_nnf_solve`` (replaces ``pallas_solve.py::fused_nnf_solve``): the
  first-generation adaptive solve, one shared MLP over B <= 128 protocols
  as a data-dependent while loop (see its section below).

The first three run one trip algorithm; the sweep is the popsweep case with
P = 1 and no cull, the population solve its case with Q = 1 and no cull.  The
trip loop itself (``_trip_loop_plain``) takes any right-hand side, and also
serves the HH population solve of ``ops/hh_solve.py``.  A trip attempts one
step for every lane at the launch's shared step size and accepts it when the
worst LIVE lane's error ratio is <= 1.
A lane that is non-finite, or still fails at h <= 2e-7, dies: it freezes,
leaves the controller and evaluates to inf.  Trips run in blocks; the solve
stops early only at a block end.  Every trip records its own attempt
(t, h, start y, 7 stages); phase 2 (``_dense_eval_*``) finds each output
time's step with ``searchsorted(right=True)`` and evaluates Shampine's
quartic.

Each wrapper sends a CPU tensor to the plain PyTorch version below and a
CUDA tensor to the hand-written kernel in ``csrc/fused_solve.cu``; it never
falls back from one to the other.  ``<wrapper>.launches`` counts kernel
launches.  The plain versions are public too (``*_plain``) so the kernels
can be held against them on the card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ionflux_torch.models.registry import HHParams, NETSCALE, VRANGE
from ionflux_torch.ops._build import count_launch
from ionflux_torch.solver.dopri5 import _A, _B_ERR, _B_SOL, _C, _P_DENSE

_SAFETY, _MINF, _MAXF = 0.9, 0.2, 10.0
_SENTINEL = 3.4e38   # a non-finite lane's error ratio

# Popsweep protocol rows: at most MAX_ROWS per launch; callers that split
# big families (eval.simulate_population) chunk at SPLIT_ROWS.
POPSWEEP_MAX_ROWS = 32
POPSWEEP_SPLIT_ROWS = 16
SWEEP_MAX_ROWS = 128
SWEEP_BLOCK = 256
MAX_ROW_TILE = 32    # protocol rows per CUDA thread block


# ---------------------------------------------------------------------------
# Shared preparation
# ---------------------------------------------------------------------------


def _layers(net):
    """A list of (W, b) from an MLP module or a list of pairs."""
    return net.layers if hasattr(net, "layers") else list(net)


def _check_f32(name, x, dim):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got {tuple(x.shape)}")


def _check_layers(layers, member_axis: bool, device):
    """Validate a (W, b) chain: f32, chained widths, 2 inputs, 1 output."""
    lead = 1 if member_axis else 0
    p = layers[0][0].shape[0] if member_axis else None
    width = 2
    for li, (w, b) in enumerate(layers):
        _check_f32(f"layer {li} weight", w, 2 + lead)
        _check_f32(f"layer {li} bias", b, 1 + lead)
        if w.device != device or b.device != device:
            raise ValueError(f"layer {li} is on {w.device}, protocols on "
                             f"{device}")
        if member_axis and (w.shape[0] != p or b.shape[0] != p):
            raise ValueError(f"layer {li} has {w.shape[0]} members, "
                             f"expected {p}")
        d_in, d_out = w.shape[lead:]
        if d_in != width or b.shape[lead] != d_out:
            raise ValueError(f"layer {li} has shape {tuple(w.shape)} / "
                             f"{tuple(b.shape)}; expected {width} inputs")
        width = d_out
    if width != 1:
        raise ValueError(f"the MLP must end in 1 output, got {width}")


def _pad_knots(v: torch.Tensor) -> torch.Tensor:
    """Pad each knot row at its end with its last value, to
    ceil(N/128)*128 + 256 knots (the kernels' clamped lookup reads
    index n_pad - 129 at most)."""
    n = v.shape[1]
    n_pad = ((n + 127) // 128) * 128 + 256
    return torch.cat([v, v[:, -1:].expand(v.shape[0], n_pad - n)],
                     dim=1).contiguous()


def _rest(p: int, q: int, device) -> torch.Tensor:
    y0 = torch.zeros((p, q, 2), dtype=torch.float32, device=device)
    y0[..., 1] = 1.0
    return y0


@dataclass(frozen=True)
class _Setup:
    """Everything a trip solve needs, for either route."""

    layers: list          # [(W [P, i, o], b [P, o])]
    vpad: torch.Tensor    # [Q, n_pad]
    y0: torch.Tensor      # [P, Q, 2]
    gate: tuple           # p5..p8 (r-gate)
    base_a: tuple         # p1..p4 (NN-d) or ()
    t0: float
    dt_knot: float
    t_end: float
    rtol: float
    atol: float
    trips: int            # rows of the record stream (B6: max_rec)
    block: int
    cull: bool
    q_split: int = 1
    bf16: bool = False    # MLP inputs rounded to bf16 per layer; the
                          # setup has rounded the weights already
    ring: bool = False    # the kernel's layer pass: the population
                          # launches' (weights through a shared-memory ring)
                          # or the sweeps' (see csrc/fused_solve.cu)
    q_real: int = 0       # rows before the popsweep's padding (0: all); the
                          # ring pass copies the padded rows' MLP outputs
    cluster: int = -1     # the sweeps' layer pass on the card: -1 as
                          # sweep_cluster's size rule picks it, 0 mlp(),
                          # C > 1 the cluster pass on clusters of C blocks


def _gate_tuples(rgate: HHParams, base_hh: HHParams | None):
    gate = base_hh if base_hh is not None else rgate
    g = tuple(float(x) for x in (gate.p5, gate.p6, gate.p7, gate.p8))
    a = (tuple(float(x) for x in (base_hh.p1, base_hh.p2, base_hh.p3,
                                  base_hh.p4))
         if base_hh is not None else ())
    return g, a


# ---------------------------------------------------------------------------
# The plain version of the trip algorithm
# ---------------------------------------------------------------------------


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _mlp_rhs(s: _Setup):
    """The right-hand side ``rhs_all(t, y)`` of the MLP gate models over
    lanes y [P, Q, 2] (t a 0-dim f32 tensor), in float32 PyTorch ops."""
    f32 = torch.float32
    dev = s.vpad.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain trip solve is float32; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    p = s.y0.shape[0]
    n_pad = s.vpad.shape[1]
    p5, p6, p7, p8 = s.gate
    inv_dt = 1.0 / s.dt_knot
    ws = [w for w, _ in s.layers]
    bs = [b[:, None, :] for _, b in s.layers]
    n_layers = len(ws)

    def voltage(t):
        # clamped knot index, no out-of-domain fallback: [Q]
        x = (t - s.t0) * inv_dt
        ii = torch.clamp(torch.floor(x).to(torch.int64), 0, n_pad - 130)
        w = x - ii.to(f32)
        v0 = s.vpad.index_select(1, ii.reshape(1))[:, 0]
        v1 = s.vpad.index_select(1, ii.reshape(1) + 1)[:, 0]
        return v0 + w * (v1 - v0)

    def mlp(x):                                        # [P, nq, 2] -> [P, nq]
        h = x
        for li in range(n_layers):
            lhs = _bf16_round(h) if s.bf16 else h
            h = torch.matmul(lhs, ws[li]) + bs[li]
            if li < n_layers - 1:
                h = torch.where(h >= 0, h, 0.01 * h)
        return h[..., 0]

    def rhs(v, y):                                     # v [nq], y [P, nq, 2]
        a, r = y[..., 0], y[..., 1]
        vn = (v / VRANGE)[None].expand(p, v.shape[0])
        dadt = mlp(torch.stack([vn, a], dim=-1)) / NETSCALE
        if s.base_a:
            p1, p2, p3, p4 = s.base_a
            k1 = p1 * torch.exp(p2 * v)
            k2 = p3 * torch.exp(-p4 * v)
            dadt = dadt + k1[None] * (1.0 - a) - k2[None] * a
        k3 = p5 * torch.exp(p6 * v)
        k4 = p7 * torch.exp(-p8 * v)
        drdt = -k3[None] * r + k4[None] * (1.0 - r)
        return torch.stack([dadt, drdt], dim=-1)

    return lambda t, y: rhs(voltage(t), y)


def _trip_solve_plain(s: _Setup):
    """The fixed-trip algorithm in PyTorch ops, in float32, for the MLP
    gate models.  Returns what ``_trip_loop_plain`` returns."""
    return _trip_loop_plain(
        _mlp_rhs(s), s.y0, t0=s.t0, t_end=s.t_end, dt_knot=s.dt_knot,
        rtol=s.rtol, atol=s.atol, trips=s.trips, block=s.block,
        cull="step" if s.cull else None)


_TAB = ([[float(x) for x in row] for row in _A], [float(x) for x in _C],
        [float(x) for x in _B_SOL], [float(x) for x in _B_ERR])


def _dp5_attempt(rhs_all, t, y, f, h_eff):
    """One DP5(4) attempt from (t, y) with first stage f: (the 7 stages,
    y1, the error estimate), in the kernels' f32 order."""
    A, C, BS, BE = _TAB
    ks = [f]
    for si in range(1, 7):
        yi = y
        for sj in range(si):
            if A[si][sj] != 0.0:
                yi = yi + (h_eff * A[si][sj]) * ks[sj]
        ks.append(rhs_all(t + C[si] * h_eff, yi))
    y1 = y
    err = torch.zeros_like(y)
    for sj in range(7):
        if BS[sj] != 0.0:
            y1 = y1 + (h_eff * BS[sj]) * ks[sj]
        if BE[sj] != 0.0:
            err = err + (h_eff * BE[sj]) * ks[sj]
    return ks, y1, err


def _trip_loop_plain(rhs_all, y0, *, t0: float, t_end: float, dt_knot: float,
                     rtol: float, atol: float, trips: int, block: int,
                     cull: str | None):
    """The trip loop itself, for any right-hand side ``rhs_all(t, y)`` over
    lanes y [P, Q, 2] (t a 0-dim f32 tensor).

    ``cull`` names the pace-cull rule applied at block ends: None, "step"
    (the popsweep's: a lane whose error-implied step cannot make the
    remaining pace) or "ratio" (the HH population's: a lane whose last
    error ratio in the block is > 0.01, i.e. one that binds the shared
    controller).  A candidate in two blocks in a row is culled.

    Returns (rec_sc [trips, 2], rec_y [trips, P, Q, 2],
    rec_k [trips, 7, P, Q, 2], n_out int32 [2] = (n_acc or its shortfall
    code, n_valid), alive bool [P, Q]).  The one host read is the early-exit
    test at each block start."""
    f32 = torch.float32
    dev = y0.device
    p, q = y0.shape[:2]

    t = torch.tensor(t0, dtype=f32, device=dev)
    f0 = rhs_all(t, y0)
    # lanes arriving non-finite (a chained carry marks dead lanes NaN), or
    # whose RHS is non-finite at the start, are dead from the start and
    # reset to rest so the RHS stays finite
    alive = (torch.isfinite(y0).all(-1) & torch.isfinite(f0).all(-1))
    y = torch.where(alive[..., None], y0, _rest(p, q, dev))
    f = torch.where(alive[..., None], f0, torch.zeros_like(f0))
    h = torch.tensor(dt_knot * 10.0, dtype=f32, device=dev)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    r_prev = torch.zeros((p, q), dtype=f32, device=dev)
    pend = torch.zeros((p, q), dtype=torch.bool, device=dev)
    sentinel = torch.tensor(_SENTINEL, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    up = torch.tensor(_MAXF, dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)

    rec_sc = torch.zeros((trips, 2), dtype=f32, device=dev)
    rec_y = torch.zeros((trips, p, q, 2), dtype=f32, device=dev)
    rec_k = torch.zeros((trips, 7, p, q, 2), dtype=f32, device=dev)
    n_blocks = trips // block
    blk = 0
    while blk < n_blocks and bool((t < t_end) & alive.any()):
        for j in range(block):
            i = blk * block + j
            h_eff = torch.clamp(torch.minimum(h, t_end - t), min=1e-8)
            ks, y1, err = _dp5_attempt(rhs_all, t, y, f, h_eff)
            scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
            r = torch.sqrt(torch.mean(torch.square(err / scale), dim=-1))
            # NaN-poison r with scale*0 so a non-finite y1 reads as bad too
            r = r + (scale[..., 0] + scale[..., 1]) * 0.0
            bad = ~(r < float("inf"))
            r_c = torch.where(bad, sentinel, r)
            ratio = torch.where(alive, r_c, zero).max()
            accept = ratio <= 1.0
            alive = alive & ((~bad & (r <= 1.0)) | (h_eff > 2e-7))
            adv = (accept & alive)[..., None]
            rec_sc[i] = torch.stack([t, h_eff])
            rec_y[i] = y
            rec_k[i] = torch.stack(ks)
            t = torch.where(accept, t + h_eff, t)
            y = torch.where(adv, y1, y)
            f = torch.where(adv, ks[6], f)
            n_acc = n_acc + accept.to(torch.int32)
            factor = _SAFETY * torch.exp(
                -0.2 * torch.log(torch.clamp(ratio, min=1e-10)))
            h = h_eff * torch.minimum(torch.clamp(factor, min=_MINF),
                                      torch.where(accept, up, one))
            r_prev = r_c
        if cull is not None:
            # pace cull: once half the trips are spent and t lags the trip
            # fraction by > 0.3, a lane that holds the launch back is a
            # candidate; two blocks in a row kill it
            spent = torch.tensor(float((blk + 1) * block), dtype=f32,
                                 device=dev)
            frac_spent = spent / float(trips)
            t_frac = (t - t0) / (t_end - t0)
            behind = (frac_spent >= 0.5) & (t_frac < frac_spent - 0.3)
            if cull == "step":
                pace = (t_end - t) / torch.clamp(float(trips) - spent,
                                                 min=1.0)
                h_lane = h * torch.exp(-0.2 * torch.log(
                    torch.clamp(r_prev, min=1e-30)))
                cand = behind & (h_lane < 0.3 * pace)
            else:
                cand = behind & (r_prev > 0.01)
            alive = alive & ~(cand & pend)
            pend = cand
        blk += 1
    ok = t >= t_end
    n_out = torch.stack([
        torch.where(ok, n_acc, -torch.clamp(n_acc, min=1)),
        torch.tensor(blk * block, dtype=torch.int32, device=dev)])
    return rec_sc, rec_y, rec_k, n_out, alive


# ---------------------------------------------------------------------------
# The CUDA route
# ---------------------------------------------------------------------------


RING_STAGES = 3            # the ring's stages (kStages in the kernel)
RING_STAGE_BYTES = 65536   # one stage of the ring: at most this per chunk
RING_PASS_COLUMNS = 256    # the columns a pass of the ring's threads covers
_SMEM_BYTES = 232448       # shared memory one block may take on Hopper


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_rt(row_tile: int) -> int:
    """The kernel's row-tile instantiation for ``row_tile`` rows."""
    return next(t for t in (1, 8, 16, 32) if row_tile <= t)


def ring_stage_cap(row_tile: int, wmax: int) -> int:
    """The largest ring stage (bytes) that fits a block's shared memory
    beside its activation buffers and lane state, for the kernel's row tile
    (1, 8, 16 or 32 rows, the instantiation ``row_tile`` rows take) and
    widest layer; as csrc/fused_solve.cu's Smem lays them out."""
    rt = _tile_rt(row_tile)
    act = 2 * _round_up(wmax, 16) * (1 if rt == 1 else rt + 4) * 4
    rest = 96 * rt + 2048
    return min(RING_STAGE_BYTES,
               (_SMEM_BYTES - act - rest) // RING_STAGES // 16 * 16)


def _ring_min_chunk(d_out: int, bf16: bool) -> int:
    """Bytes of the smallest chunk of a layer with ``d_out`` outputs: one
    k-row of [in, round4(out)] in f32, one mma k-step of the transposed
    layer ([round8(out), 16 + 8]) in bf16."""
    return (2 * _round_up(d_out, 8) * (16 + 8) if bf16
            else 4 * _round_up(d_out, 4))


def _ring_cap(row_tile: int, sizes, bf16: bool) -> int:
    """``ring_stage_cap`` at the instantiation the kernel launches: bf16
    runs one row in an 8-row tile (the mma's rows), never at RT = 1."""
    return ring_stage_cap(max(row_tile, 2) if bf16 else row_tile, max(sizes))


def ring_fits(row_tile: int, sizes, bf16: bool) -> bool:
    """Whether the ring pass takes a net of layer widths ``sizes`` at
    ``row_tile`` rows per block: the capped stage holds the smallest chunk
    of every layer."""
    cap = _ring_cap(row_tile, sizes, bf16)
    return cap >= 16 and all(_ring_min_chunk(d, bf16) <= cap
                             for d in sizes[1:])


def _ring_tile(row_tile: int, sizes, bf16: bool) -> int | None:
    """``ring_row_tile``'s tile, or None where no tile fits."""
    return next((rt for rt in (row_tile, 16, 8, 1)
                 if rt <= row_tile and ring_fits(rt, sizes, bf16)), None)


def ring_row_tile(row_tile: int, sizes, bf16: bool) -> int:
    """The size rule of the population launches' layer pass (B1 in both
    modes, B4): the rows a block takes, ``row_tile`` (what Q and q_split
    ask for) when the ring's stages, activation buffers and lane state fit a
    block's shared memory at that tile, else the largest smaller tile of the
    kernel's (16, 8, and in f32 1) that fits.  The result does not depend
    on the tile (each row's sums run in one order).  A d1-sized or 500-wide
    net keeps ``row_tile``; a (2, w, w, 1) net fits up to w = 11,512 in
    f32 (one row) and 952 in bf16 (8 rows).  Raises for a net no tile
    takes (``population_pass`` then takes mlp())."""
    rt = _ring_tile(row_tile, sizes, bf16)
    if rt is None:
        raise ValueError(
            f"the ring pass cannot hold a layer {max(sizes)} wide in a "
            f"block's shared memory ({'bf16' if bf16 else 'f32'})")
    return rt


def mlp_smem_bytes(row_tile: int, wmax: int) -> int:
    """Dynamic shared memory of one block of the mlp() pass: two row-major
    activation buffers [RT, wmax] f32 and the lane state at the kernel's
    instantiation for ``row_tile`` rows, as csrc/fused_solve.cu's Smem lays
    them out: 8 RT wmax + 96 RT bytes."""
    rt = _tile_rt(row_tile)
    return 4 * (2 * rt * wmax + 7 * rt * 2 + 3 * rt * 2 + 2 * rt) + 4 * 2 * rt


def mlp_row_tile(row_tile: int, sizes) -> int:
    """The rows per block of the population launches' second layer pass,
    mlp() (each member's weights read from L2 and HBM, no ring): the
    largest of ``row_tile``, 16, 8 and 1, at most ``row_tile``, whose
    activation buffers and lane state fit a block.  The one-row block holds
    8 wmax + 96 bytes, so a layer wider than (232,448 - 1,024 - 96) / 8 =
    28,916 fits no tile: that raises ``ValueError``, the stated limit of
    the population kernels on the card."""
    room = _SMEM_BYTES - _SMEM_STATIC
    wmax = max(sizes)
    for rt in (row_tile, 16, 8, 1):
        if rt <= row_tile and mlp_smem_bytes(rt, wmax) <= room:
            return rt
    raise ValueError(
        f"no layer pass holds a layer {wmax} wide: mlp()'s one-row block "
        f"needs 8 x {wmax} + 96 = {mlp_smem_bytes(1, wmax)} bytes of "
        f"shared memory for its two activation buffers and lane state, "
        f"over the {room} a block may take (the ring pass held none "
        f"either)")


def population_pass(row_tile: int, sizes, bf16: bool) -> tuple[int, dict]:
    """The size rule of the population launches (B1 in both modes, B4),
    decided from the widths before any launch: the ring pass at
    ``ring_row_tile``'s tile where a tile fits, else mlp() at
    ``mlp_row_tile``'s (past 11,512 wide in f32, 952 in bf16, for a (2, w,
    w, 1) net), else ``ValueError``.  Returns the row tile and the pass as
    ``last_pass`` names it."""
    rt = _ring_tile(row_tile, sizes, bf16)
    if rt is not None:
        return rt, dict(layer_pass="ring", row_tile=rt,
                        column_passes=ring_column_passes(rt, sizes, bf16))
    rt = mlp_row_tile(row_tile, sizes)
    return rt, dict(layer_pass="mlp", row_tile=rt)


def ring_column_passes(row_tile: int, sizes, bf16: bool) -> int:
    """The passes the ring's threads make over each chunk of the widest
    layer: 1 up to RING_PASS_COLUMNS columns (4 x as many at one row per
    block, one column group per thread), more beyond (the kernel parks the
    running sums in shared memory between chunks)."""
    d_out = max(sizes[1:])
    if bf16:
        return -(-_round_up(d_out, 8) // RING_PASS_COLUMNS)
    rt = _tile_rt(row_tile)
    groups = 1 if rt == 1 else rt // 2          # row groups (ring_tr)
    per_pass = -(-groups * 64 // 256) * 256     # NT * kThreads tasks
    return -(-groups * (_round_up(d_out, 4) // 4) // per_pass)


def ring_geometry(sizes, bf16: bool, stage_cap: int = RING_STAGE_BYTES):
    """How ``_ring_pack`` lays out one member's layers for the ring pass:
    per layer (offset in elements, chunk depth in k, number of chunks), the
    member's stride in elements and the stage size in bytes.

    f32: layer l is row-major [in, round4(out)], and a chunk is up to kc of
    its k-rows.  bf16: layer l is transposed, [round8(out), round16(in)],
    and a chunk is its [round8(out), kc] slice of k (the last one
    narrower), each slice stored whole with every row padded by 8 zeros (so
    the kernel's B-fragment loads from the stage hit distinct banks).  A
    chunk is one contiguous block, copied whole into a stage; chunks are
    balanced over k and fit a stage of ``stage_cap`` bytes."""
    geom, off, stage = [], 0, 16
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        if bf16:   # k in mma steps of 16
            cols, depth = _round_up(d_out, 8), _round_up(d_in, 16)
            most = (stage_cap // (2 * cols) - 8) // 16 * 16
            step = 16
        else:
            cols, depth = _round_up(d_out, 4), d_in
            most, step = stage_cap // (4 * cols), 1
        kc = _round_up(-(-depth // -(-depth // most)), step)
        nch = -(-depth // kc)
        geom.append((off, kc, nch))
        if bf16:
            off += cols * (depth + 8 * nch)
            stage = max(stage, cols * (kc + 8) * 2)
        else:
            off += depth * cols
            stage = max(stage, kc * cols * 4)
    return geom, off, stage


def _ring_pack(layers, bf16: bool, stage_cap: int = RING_STAGE_BYTES):
    """Each member's weights as one packed row for the ring pass ([P, stride]
    f32, or bf16 when ``bf16``), zero in every padding, with
    ``ring_geometry``'s layer geometry and stage bytes.  Every chunk starts
    and ends on a 16-byte boundary."""
    p = layers[0][0].shape[0]
    sizes = [layers[0][0].shape[1]] + [w.shape[2] for w, _ in layers]
    geom, _, stage = ring_geometry(sizes, bf16, stage_cap)
    parts = []
    for (w, _), (_, kc, _) in zip(layers, geom):
        d_in, d_out = w.shape[1:]
        if bf16:
            wt = torch.zeros((p, _round_up(d_out, 8), _round_up(d_in, 16)),
                             dtype=w.dtype, device=w.device)
            wt[:, :d_out, :d_in] = w.transpose(1, 2)
            parts += [torch.nn.functional.pad(wt[:, :, k0:k0 + kc],
                                              (0, 8)).reshape(p, -1)
                      for k0 in range(0, wt.shape[2], kc)]
        else:
            wp = torch.zeros((p, d_in, _round_up(d_out, 4)), dtype=w.dtype,
                             device=w.device)
            wp[:, :, :d_out] = w
            parts.append(wp.reshape(p, -1))
    packed = torch.cat(parts, dim=1)
    return ((packed.to(torch.bfloat16) if bf16 else packed).contiguous(),
            geom, stage)


# The sweeps' cluster pass (B2, B6): clusters of CLUSTER_SIZE blocks, the
# faster of 8 and 16 at chip_smoke.py's (b) (PERF.md); 16 needs the
# non-portable cluster size and fits 7 clusters on the card, 8 fits 15
CLUSTER_SIZE = 8
CLUSTER_COLS = 2           # a slice's columns are a multiple of this
                           # (kClusterCols: a thread task's columns)
_SMEM_STATIC = 1024        # what a launch keeps back for static shared memory


def cluster_geometry(sizes, csize: int):
    """How ``_cluster_pack`` lays out one rank's row for the cluster pass:
    per layer (offset in floats, columns per block), and the floats of the
    row.  A hidden layer's slice is ceil(out / csize) columns rounded up
    to CLUSTER_COLS, [in, cols] row-major then the cols biases; layer 0 (2
    inputs) and the last layer (one output) are whole in every rank
    (layer 0's columns rounded up too), computed by every block without an
    exchange.  Padded columns are zero.  Each slice is padded to 4 floats,
    so every bulk copy moves whole 16-byte words between 16-byte-aligned
    addresses."""
    geom, off = [], 0
    for l, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        cols = (1 if d_out == 1
                else _round_up(d_out if l == 0 else -(-d_out // csize),
                               CLUSTER_COLS))
        geom.append((off, cols))
        off += _round_up((d_in + 1) * cols, 4)
    return geom, off


def _cluster_pack(layers, csize: int):
    """The weights and biases of one net (layers [(W [1, in, out], b [1,
    out])]) as csize packed rows [csize, stride] f32, rank q's holding
    columns [q cols, (q + 1) cols) of every hidden layer and layer 0 and the
    last layer whole, zero in every padding; with ``cluster_geometry``'s
    geometry."""
    sizes = [layers[0][0].shape[1]] + [w.shape[2] for w, _ in layers]
    geom, stride = cluster_geometry(sizes, csize)
    w0 = layers[0][0]
    out = torch.zeros((csize, stride), dtype=torch.float32, device=w0.device)
    for (w, b), (off, cols) in zip(layers, geom):
        d_in, d_out = w.shape[1:]
        ranks = 1 if cols >= d_out else csize   # whole, or sliced
        wp = torch.zeros((d_in, ranks * cols), dtype=w.dtype, device=w.device)
        wp[:, :d_out] = w[0]
        wq = wp.reshape(d_in, ranks, cols).transpose(0, 1).reshape(
            ranks, d_in * cols).expand(csize, d_in * cols)
        bq = torch.zeros(ranks * cols, dtype=b.dtype, device=b.device)
        bq[:d_out] = b[0]
        bq = bq.reshape(ranks, cols).expand(csize, cols)
        out[:, off:off + d_in * cols] = wq
        out[:, off + d_in * cols:off + (d_in + 1) * cols] = bq
    return out, geom, stride


def cluster_smem_bytes(row_tile: int, sizes, csize: int) -> int:
    """Dynamic shared memory of one block of the cluster pass: its weight
    row, three exchange buffers [wmax, RT + 4], the layer-0 input and the
    output [2, RT + 4] each, and the lane state, as csrc/fused_solve.cu's
    Smem lays them out."""
    rt = max(8, _tile_rt(row_tile))
    rts = rt + 4
    _, stride = cluster_geometry(sizes, csize)
    return 4 * (stride + 3 * max(sizes) * rts + 2 * 2 * rts + 7 * rt * 2
                + 3 * rt * 2 + 2 * rt) + 4 * 2 * rt


def sweep_cluster(sizes, row_tile: int, csize: int = CLUSTER_SIZE) -> int:
    """The size rule of the sweeps' layer pass: ``csize`` (the cluster pass)
    when every hidden layer is at least 2 wide (a one-wide hidden layer
    keeps mlp()'s sum order only in mlp()) and a block's slices, buffers
    and lane state fit the shared memory a block may take; 0 (mlp(), the
    weights read from L2) otherwise."""
    if min(sizes[1:-1], default=2) < 2:
        return 0
    fits = cluster_smem_bytes(row_tile, sizes, csize) <= (
        _SMEM_BYTES - _SMEM_STATIC)
    return csize if fits else 0


def _sweep_pass(s: _Setup, row_tile: int) -> int:
    """The blocks per cluster of a sweep launch (0: mlp()): the size rule,
    or what ``s.cluster`` forces.  Raises for a forced size that does not
    fit."""
    sizes = [s.layers[0][0].shape[1]] + [w.shape[2] for w, _ in s.layers]
    if s.cluster < 0:
        return sweep_cluster(sizes, row_tile)
    if s.cluster and sweep_cluster(sizes, row_tile, s.cluster) != s.cluster:
        raise ValueError(f"the cluster pass at C = {s.cluster} does not take "
                         f"this net at {row_tile} rows")
    return s.cluster


def _pass_info(csize: int, units: int) -> dict:
    return dict(layer_pass="cluster" if csize else "mlp",
                cluster_size=csize, clusters=units if csize else 0)


def launch_plan(s: _Setup) -> tuple[int, dict]:
    """How a trip launch runs on the card: the rows per thread block (or
    cluster) and the layer pass, by the stated rules.  The popsweep and the
    population solve take ``population_pass``'s (the ring, or mlp() for
    layers too wide for it); the sweep takes ``sweep_cluster``'s pass (or
    what ``s.cluster`` forces).  The dict names the pass: {"layer_pass":
    "ring", "row_tile", "column_passes"}, {"layer_pass": "mlp", "row_tile"}
    or ``_pass_info``'s fields."""
    p, q = s.y0.shape[:2]
    sizes = [s.layers[0][0].shape[1]] + [w.shape[2] for w, _ in s.layers]
    row_tile = min(MAX_ROW_TILE, q // s.q_split)
    if s.ring:
        return population_pass(row_tile, sizes, s.bf16)
    return row_tile, _pass_info(_sweep_pass(s, row_tile),
                                p * -(-q // row_tile))


def weight_stream_bytes(sizes, p: int, info: dict) -> int:
    """Bytes of packed float32 member weights that one right-hand side of a
    population launch reads, for ``population_pass``'s pass ``info``,
    padding included, biases not: the ring's rows (``ring_geometry``'s
    stride at the launch's stage cap) or mlp()'s row-major W0, W1, ..., for
    each of the ``p`` members.  The cluster pass serves the sweeps only,
    never these launches."""
    if info["layer_pass"] == "ring":
        _, stride, _ = ring_geometry(
            sizes, False, _ring_cap(info["row_tile"], sizes, False))
        return 4 * p * stride
    return 4 * p * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def _popsweep_rows(q_req: int) -> int:
    """The popsweep's rows: Q padded to a power of two >= 2."""
    return max(2, 1 << (q_req - 1).bit_length())


def popsweep_plan(p: int, q_req: int, sizes) -> tuple[int, dict, int]:
    """``launch_plan`` of a float32 popsweep launch of ``p`` members on
    ``q_req`` protocol rows (no ``q_split``), from the shapes alone (no
    setup, no launch), and the bytes of member weights one right-hand side
    of it streams (``weight_stream_bytes``): (row tile, pass, bytes)."""
    sizes = list(sizes)
    rt, info = population_pass(min(MAX_ROW_TILE, _popsweep_rows(q_req)),
                               sizes, False)
    return rt, info, weight_stream_bytes(sizes, p, info)


def _kernel_inputs(s: _Setup, row_tile: int = MAX_ROW_TILE,
                   layer_pass: str | None = None):
    """What both CUDA entry points take besides the outputs: the weights as
    one flat row per member (bf16 when ``s.bf16``): W0, W1, ... row-major
    [in, out] for mlp(), ``_ring_pack``'s layout for the ring, or
    ``_cluster_pack``'s rows for the sweeps' cluster pass; the ring's
    geometry (or None), the biases in f32, the layer widths, the 16 scalars
    and the cluster pass's (blocks per cluster, geometry, floats per rank),
    (0, None, 0) for the other passes.  ``row_tile`` sizes the ring's
    stages and decides the sweeps' pass; ``launch_plan`` gives it and the
    ``layer_pass`` (by default the ring for the population launches)."""
    if len(s.layers) > 16:
        raise ValueError("the CUDA kernel takes at most 16 layers")
    p = s.y0.shape[0]
    sizes = [s.layers[0][0].shape[1]] + [w.shape[2] for w, _ in s.layers]
    use_ring = layer_pass == "ring" or (layer_pass is None and s.ring)
    csize = 0 if s.ring else _sweep_pass(s, row_tile)
    cluster = (0, None, 0)
    if use_ring:
        if not ring_fits(row_tile, sizes, s.bf16):
            raise ValueError(f"the ring pass does not take this net at "
                             f"{row_tile} rows: use launch_plan's tile")
        # exact in bf16: the setup rounded the weights
        wflat, geom, stage = _ring_pack(
            s.layers, s.bf16, _ring_cap(row_tile, sizes, s.bf16))
        ring = ((ctypes.c_int * (3 * len(geom)))(*sum(geom, ())), stage)
    elif csize:
        wflat, geom, stride = _cluster_pack(s.layers, csize)
        ring = None
        cluster = (csize, (ctypes.c_int * (2 * len(geom)))(*sum(geom, ())),
                   stride)
    else:
        wflat = torch.cat([w.reshape(p, -1) for w, _ in s.layers], dim=1)
        if s.bf16:        # exact: the setup rounded the weights
            wflat = wflat.to(torch.bfloat16)
        ring = None
    bflat = torch.cat([b.reshape(p, -1) for _, b in s.layers], dim=1)
    p1, p2, p3, p4 = s.base_a if s.base_a else (0.0, 0.0, 0.0, 0.0)
    f = np.float32
    scal = (ctypes.c_float * 16)(
        f(s.t0), f(1.0 / s.dt_knot), f(s.dt_knot * 10.0), f(s.t_end),
        f(s.t_end - s.t0), f(s.rtol), f(s.atol), f(float(s.trips)),
        p1, p2, p3, p4, *s.gate)
    return (wflat.contiguous(), ring, bflat.contiguous(),
            (ctypes.c_int * len(sizes))(*sizes), scal, cluster)


def _trip_solve_cuda(s: _Setup):
    """Launch the cooperative trip kernel (csrc/fused_solve.cu) on the
    tensors' device and current stream; same outputs as the plain version.
    A thread block, or a cluster of blocks in the sweeps' cluster pass, owns
    up to MAX_ROW_TILE rows of one member (fewer with ``q_split``; the
    result does not depend on the tiling; ``launch_plan`` picks it).  Raises
    on a refused launch; never synchronises.  ``_trip_solve_cuda.last_pass``
    names the layer pass the launch took: its row tile and column passes
    (the ring), or its cluster size and clusters (the sweeps)."""
    from ionflux_torch.ops._build import launch

    dev = s.vpad.device
    p, q = s.y0.shape[:2]
    row_tile, info = launch_plan(s)
    wflat, ring, bflat, c_sizes, scal, cluster = _kernel_inputs(
        s, row_tile, info["layer_pass"])
    geom, stage = ring if ring else (None, 0)
    grid = p * -(-q // row_tile)     # blocks, or clusters
    rec_sc = torch.empty((s.trips, 2), dtype=torch.float32, device=dev)
    rec_y = torch.empty((s.trips, p, q, 2), dtype=torch.float32, device=dev)
    rec_k = torch.empty((s.trips, 7, p, q, 2), dtype=torch.float32,
                        device=dev)
    n_out = torch.empty(2, dtype=torch.int32, device=dev)
    alive = torch.empty((p, q), dtype=torch.uint8, device=dev)
    partial = torch.empty((2, grid, 2), dtype=torch.int32, device=dev)
    y0 = s.y0.contiguous()
    launch("fused_solve", "ionflux_trip_solve", dev,
            s.vpad.data_ptr(), y0.data_ptr(), wflat.data_ptr(),
            wflat.shape[1], bflat.data_ptr(), bflat.shape[1], int(s.bf16),
            rec_sc.data_ptr(), rec_y.data_ptr(), rec_k.data_ptr(),
            n_out.data_ptr(), alive.data_ptr(), partial.data_ptr(), c_sizes,
            len(s.layers), p, q, s.vpad.shape[1], row_tile, s.trips,
            s.block, int(s.cull), int(bool(s.base_a)), scal, int(bool(ring)),
            geom, stage, s.q_real, *cluster)
    _trip_solve_cuda.last_pass = info
    return rec_sc, rec_y, rec_k, n_out, alive.bool()


_trip_solve_cuda.last_pass = None


# ---------------------------------------------------------------------------
# Phase 2: dense output
# ---------------------------------------------------------------------------

_DENSE_CHUNK_ELEMS = 1 << 24   # bound on the [T, 7, P, Q, 2] record gather
_P_DENSE_ON = {}               # device -> Shampine's quartic coefficients
_TIMES_ON = {}                 # (device, t) -> the one-time tensor [t]


def _time_on(device, t: float) -> torch.Tensor:
    """The f32 tensor [t] on ``device``, made there once: a chain of launches
    that asks for y(t_end) makes no host-to-device copy, so a CUDA graph can
    capture it.  Read-only."""
    key = (device, float(t))
    if key not in _TIMES_ON:
        _TIMES_ON[key] = torch.tensor([float(t)], dtype=torch.float32,
                                      device=device)
    return _TIMES_ON[key]


def _p_dense(device) -> torch.Tensor:
    """Shampine's dense-output coefficients on ``device``, copied there
    once: phase 2 then makes no host-to-device copy, so a CUDA graph can
    capture it."""
    if device not in _P_DENSE_ON:
        _P_DENSE_ON[device] = torch.as_tensor(_P_DENSE, dtype=torch.float32,
                                              device=device)
    return _P_DENSE_ON[device]


def _dense_eval_popsweep_ft(rec_sc, rec_y, rec_k, n_acc, n_valid,
                            ts: torch.Tensor) -> torch.Tensor:
    """ys [P, Q, T, 2] from the record stream (records past n_valid are
    masked to +inf; n_acc <= 0 means t_end was not reached: all inf).  The
    output times go through in chunks, so the record gather stays under
    _DENSE_CHUNK_ELEMS floats for any T."""
    trips, _, p, q, _ = rec_k.shape
    ts = ts.to(device=rec_sc.device, dtype=torch.float32)
    t_rec = torch.where(
        torch.arange(trips, device=rec_sc.device) < n_valid, rec_sc[:, 0],
        torch.full_like(rec_sc[:, 0], _SENTINEL))
    p_dense = _p_dense(rec_sc.device)
    chunk = max(1, _DENSE_CHUNK_ELEMS // (7 * p * q * 2))
    parts = []
    for c0 in range(0, ts.shape[0], chunk):
        tc = ts[c0:c0 + chunk]
        idx = torch.clamp(torch.searchsorted(t_rec, tc, right=True) - 1,
                          0, trips - 1)
        t0s = rec_sc[idx, 0]
        hs = torch.clamp(rec_sc[idx, 1], min=1e-20)
        th = torch.clamp((tc - t0s) / hs, 0.0, 1.0)
        tp = torch.stack([th, th * th, th * th * th, (th * th) * (th * th)],
                         dim=-1)
        bpoly = tp @ p_dense.T                                   # [T, 7]
        ys = rec_y[idx] + hs[:, None, None, None] * torch.einsum(
            "tj,tjpqs->tpqs", bpoly, rec_k[idx])
        parts.append(ys)
    ys = torch.cat(parts, dim=0).permute(1, 2, 0, 3)             # [P,Q,T,2]
    return torch.where(n_acc > 0, ys, torch.full_like(ys, float("inf")))


def _dense_eval_ft(rec_sc, rec_y, rec_k, n_acc, n_valid, ts,
                   lane_ok: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 2 of the sweep: ys [B, T, 2]; lane_ok [B] infs dead lanes."""
    ys = _dense_eval_popsweep_ft(rec_sc, rec_y, rec_k, n_acc, n_valid,
                                 ts)[0]
    if lane_ok is not None:
        ys = torch.where(lane_ok[:, None, None], ys,
                         torch.full_like(ys, float("inf")))
    return ys


# ---------------------------------------------------------------------------
# B2: the sweep (one shared net x B protocols)
# ---------------------------------------------------------------------------


def _sweep_setup(net, rgate, protos_v, ts, proto_t0, proto_dt, t_end, rtol,
                 atol, trips, base_hh, block=SWEEP_BLOCK) -> _Setup:
    _check_f32("protos_v", protos_v, 2)
    layers = _layers(net)
    _check_layers(layers, member_axis=False, device=protos_v.device)
    b = protos_v.shape[0]
    if b > SWEEP_MAX_ROWS:
        raise ValueError(
            f"the sweep kernel takes at most {SWEEP_MAX_ROWS} protocol rows "
            f"(got B={b}); split the family, as eval.simulate_family does")
    if trips < 1 or trips % block:
        raise ValueError(f"trips must be a positive multiple of {block}, "
                         f"got {trips}")
    gate, base_a = _gate_tuples(rgate, base_hh)
    return _Setup(
        layers=[(w[None], bb[None]) for w, bb in layers],
        vpad=_pad_knots(protos_v), y0=_rest(1, b, protos_v.device),
        gate=gate, base_a=base_a, t0=float(proto_t0), dt_knot=float(proto_dt),
        t_end=float(t_end) if t_end is not None else float(ts[-1]),
        rtol=float(rtol), atol=float(atol), trips=int(trips),
        block=block, cull=False)


def _sweep(net, rgate, protos_v, ts, *, proto_t0, proto_dt, t_end, rtol,
           atol, trips, base_hh, plain):
    s = _sweep_setup(net, rgate, protos_v, ts, proto_t0, proto_dt, t_end,
                     rtol, atol, trips, base_hh)
    if plain or not protos_v.is_cuda:
        out = _trip_solve_plain(s)
    else:
        out = _trip_solve_cuda(s)
        count_launch(fused_nnf_solve_ft)
        fused_nnf_solve_ft.last_pass = _trip_solve_cuda.last_pass
    rec_sc, rec_y, rec_k, n_out, alive = out
    return _dense_eval_ft(rec_sc, rec_y, rec_k, n_out[0], n_out[1], ts,
                          lane_ok=alive[0])


def fused_nnf_solve_ft(net, rgate: HHParams, protos_v: torch.Tensor,
                       ts: torch.Tensor, *, proto_t0: float = 0.0,
                       proto_dt: float = 0.1, t_end: float | None = None,
                       rtol: float = 1e-5, atol: float = 1e-7,
                       trips: int = 3072,
                       base_hh: HHParams | None = None) -> torch.Tensor:
    """Fixed-trip fused solve of one NN-f net (NN-d with ``base_hh``) over
    B <= 128 protocols from rest: ys [B, T, 2].  ``trips`` (a multiple of
    256) must exceed the attempts the solve needs, or every output is inf.
    A lane that diverges returns inf for its row only.  CUDA tensors run the
    kernel; CPU tensors run ``fused_nnf_solve_ft_plain``."""
    return _sweep(net, rgate, protos_v, ts, proto_t0=proto_t0,
                  proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                  trips=trips, base_hh=base_hh, plain=False)


fused_nnf_solve_ft.launches = 0
fused_nnf_solve_ft.last_pass = None   # the last launch's layer pass


def fused_nnf_solve_ft_plain(net, rgate: HHParams, protos_v: torch.Tensor,
                             ts: torch.Tensor, *, proto_t0: float = 0.0,
                             proto_dt: float = 0.1,
                             t_end: float | None = None, rtol: float = 1e-5,
                             atol: float = 1e-7, trips: int = 3072,
                             base_hh: HHParams | None = None) -> torch.Tensor:
    """The plain PyTorch version of ``fused_nnf_solve_ft``, on any device."""
    return _sweep(net, rgate, protos_v, ts, proto_t0=proto_t0,
                  proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                  trips=trips, base_hh=base_hh, plain=True)


# ---------------------------------------------------------------------------
# B1: the popsweep (P member nets x Q protocols)
# ---------------------------------------------------------------------------


def popsweep_block(q: int) -> int:
    """Trips per block for Q padded rows (the reference's record-ring rule,
    kept so n_valid and cull timing match)."""
    block = 256
    while block > 32 and block * 7 * 2 * q * 128 * 4 > 6 * 1024 * 1024:
        block //= 2
    return block


@dataclass(frozen=True)
class PopsweepRecords:
    """The popsweep record stream (phase 1 output): rec_sc [trips, 2],
    rec_y [trips, P, Q, 2], rec_k [trips, 7, P, Q, 2] over the Q padded
    rows; mask [P, Q] is each lane's survival flag."""

    rec_sc: torch.Tensor
    rec_y: torch.Tensor
    rec_k: torch.Tensor
    n_acc: torch.Tensor
    n_valid: torch.Tensor
    p: int
    q: int
    q_req: int
    mask: torch.Tensor

    def evaluate(self, ts: torch.Tensor) -> torch.Tensor:
        """ys [P, Q_req, T, 2] at ts; dead lanes are inf."""
        ys = _dense_eval_popsweep_ft(self.rec_sc, self.rec_y, self.rec_k,
                                     self.n_acc, self.n_valid, ts)
        return torch.where(self.mask[:, :self.q_req, None, None],
                           ys[:, :self.q_req],
                           torch.full_like(ys[:, :self.q_req], float("inf")))

    def final_state(self, t_end: float) -> torch.Tensor:
        """y(t_end) [P, Q_req, 2]; dead lanes carry NaN, so a next launch
        that takes it as y0 starts them dead."""
        ys = _dense_eval_popsweep_ft(self.rec_sc, self.rec_y, self.rec_k,
                                     self.n_acc, self.n_valid,
                                     _time_on(self.rec_sc.device, t_end))
        return torch.where(self.mask[:, :self.q_req, None],
                           ys[:, :self.q_req, 0, :],
                           torch.full_like(ys[:, :self.q_req, 0, :],
                                           float("nan")))


def _popsweep_setup(nets, rgate, protos_v, ts, proto_t0, proto_dt, t_end,
                    rtol, atol, trips, base_hh, y0, cull, mxu_bf16,
                    q_split) -> _Setup:
    _check_f32("protos_v", protos_v, 2)
    layers = _layers(nets)
    dev = protos_v.device
    _check_layers(layers, member_axis=True, device=dev)
    p = layers[0][0].shape[0]
    q_req, n = protos_v.shape
    if p > 128:
        raise ValueError(f"popsweep takes at most 128 members (got P={p})")
    q_split = int(q_split)
    # Q padded to a power of two >= 2 by repeating the last row
    q = _popsweep_rows(q_req)
    if q_split < 1 or q % q_split:
        raise ValueError(f"q_split={q_split} must divide the padded "
                         f"protocol rows Q={q}")
    if q > POPSWEEP_MAX_ROWS * q_split:
        raise ValueError(
            f"popsweep supports at most {POPSWEEP_MAX_ROWS} protocol rows "
            f"per launch (got Q={q_req}, pads to {q}); split into "
            f"<={POPSWEEP_MAX_ROWS}-row launches, as "
            f"eval.simulate_population does")
    if q != q_req:
        protos_v = torch.cat(
            [protos_v, protos_v[-1:].expand(q - q_req, n)], dim=0)
    if y0 is None:
        y0 = _rest(p, q, dev)
    else:
        _check_f32("y0", y0, 3)
        if y0.device != dev:
            raise ValueError(f"y0 is on {y0.device}, protocols on {dev}")
        if tuple(y0.shape) != (p, q_req, 2):
            raise ValueError(f"y0 must be [{p}, {q_req}, 2], got "
                             f"{tuple(y0.shape)}")
        if q != q_req:
            y0 = torch.cat([y0, y0[:, -1:].expand(p, q - q_req, 2)], dim=1)
    if mxu_bf16:
        # bf16 weights; and past 8 padded rows the reference folds each
        # bias into its weight matrix as a row against a ones column before
        # the cast to bf16 (fold_bias = q > 8, pallas_solve.py:1533, a
        # Mosaic workaround), so there the biases are bf16 too.  The ones
        # column is exact in bf16; summing the bias inside the dot only
        # reorders f32 sums.
        layers = [(_bf16_round(w), _bf16_round(b) if q > 8 else b)
                  for w, b in layers]
    block = popsweep_block(q)
    gate, base_a = _gate_tuples(rgate, base_hh)
    return _Setup(
        layers=layers, vpad=_pad_knots(protos_v), y0=y0, gate=gate,
        base_a=base_a, t0=float(proto_t0), dt_knot=float(proto_dt),
        t_end=float(t_end) if t_end is not None else float(ts[-1]),
        rtol=float(rtol), atol=float(atol),
        trips=-(-int(trips) // block) * block, block=block, cull=bool(cull),
        q_split=q_split, bf16=bool(mxu_bf16), ring=True, q_real=q_req)


def _popsweep(nets, rgate, protos_v, ts, *, proto_t0, proto_dt, t_end, rtol,
              atol, trips, base_hh, y0, return_records, cull, mxu_bf16,
              q_split, plain):
    s = _popsweep_setup(nets, rgate, protos_v, ts, proto_t0, proto_dt, t_end,
                        rtol, atol, trips, base_hh, y0, cull, mxu_bf16,
                        q_split)
    p, q = s.y0.shape[:2]
    q_req = protos_v.shape[0]
    if plain or not protos_v.is_cuda:
        out = _trip_solve_plain(s)
    else:
        out = _trip_solve_cuda(s)
        count_launch(fused_nnf_popsweep_solve_ft)
    rec_sc, rec_y, rec_k, n_out, alive = out
    recs = PopsweepRecords(rec_sc, rec_y, rec_k, n_out[0], n_out[1], p, q,
                           q_req, alive)
    return recs if return_records else recs.evaluate(ts)


def fused_nnf_popsweep_solve_ft(
    nets, rgate: HHParams, protos_v: torch.Tensor, ts: torch.Tensor, *,
    proto_t0: float = 0.0, proto_dt: float = 0.1,
    t_end: float | None = None, rtol: float = 1e-5, atol: float = 1e-7,
    trips: int = 2048, base_hh: HHParams | None = None,
    y0: torch.Tensor | None = None, return_records: bool = False,
    cull: bool = True, mxu_bf16: bool = False, q_split: int = 1,
):
    """Fixed-trip fused solve of P member nets (W [P, i, o], b [P, o]) x
    Q <= 32 protocols on one shared clock: ys [P, Q, T, 2], or the raw
    ``PopsweepRecords`` with ``return_records``.  ``base_hh`` switches to
    NN-d; ``y0`` [P, Q, 2] seeds each lane (NaN starts a lane dead);
    ``cull`` enables the pace cull; ``q_split`` (a divisor of the padded Q)
    spreads each member's rows over that many thread blocks on the card,
    with the same result.  ``mxu_bf16`` rounds the MLP operands (each
    layer's input and weights, and the biases too where the padded Q > 8)
    to bf16 with f32 sums.  CUDA tensors run the kernel; CPU tensors run
    ``fused_nnf_popsweep_solve_ft_plain``."""
    return _popsweep(nets, rgate, protos_v, ts, proto_t0=proto_t0,
                     proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                     trips=trips, base_hh=base_hh, y0=y0,
                     return_records=return_records, cull=cull,
                     mxu_bf16=mxu_bf16, q_split=q_split, plain=False)


fused_nnf_popsweep_solve_ft.launches = 0


def fused_nnf_popsweep_solve_ft_plain(
    nets, rgate: HHParams, protos_v: torch.Tensor, ts: torch.Tensor, *,
    proto_t0: float = 0.0, proto_dt: float = 0.1,
    t_end: float | None = None, rtol: float = 1e-5, atol: float = 1e-7,
    trips: int = 2048, base_hh: HHParams | None = None,
    y0: torch.Tensor | None = None, return_records: bool = False,
    cull: bool = True, mxu_bf16: bool = False, q_split: int = 1,
):
    """The plain PyTorch version of ``fused_nnf_popsweep_solve_ft``, on any
    device."""
    return _popsweep(nets, rgate, protos_v, ts, proto_t0=proto_t0,
                     proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                     trips=trips, base_hh=base_hh, y0=y0,
                     return_records=return_records, cull=cull,
                     mxu_bf16=mxu_bf16, q_split=q_split, plain=True)


def fused_nnf_popsweep_chained(
    nets, rgate: HHParams, seg_v: torch.Tensor, *, proto_dt: float = 0.1,
    t_end: float | None = None, rtol: float = 1e-5, atol: float = 1e-7,
    trips: int = 6144, base_hh: HHParams | None = None,
    y0: torch.Tensor | None = None, cull: bool = True,
    mxu_bf16: bool = False, q_split: int = 1, consume=None,
    ts: torch.Tensor | None = None,
):
    """The popsweep chained over the segments of long recordings: one
    ``fused_nnf_popsweep_solve_ft`` launch per segment of ``seg_v`` [B, Q,
    L] on a local f32 clock from 0 to ``t_end`` (default (L - 1) proto_dt,
    or ts[-1]), each segment's final state the next one's y0 (NaN carries a
    dead lane into the next launch dead).  Segment edges need not fall on
    sweep edges.  ``consume(b, recs)`` takes each segment's
    ``PopsweepRecords`` (dense-evaluate or reduce there); without it the
    segments are evaluated at the local times ``ts``.  Makes no host
    synchronisation itself.  Returns (None with ``consume``, else ys [B, P,
    Q, T, 2]; y_final [P, Q, 2])."""
    if consume is None and ts is None:
        raise ValueError("fused_nnf_popsweep_chained needs either a consume "
                         "callback or local output times ts")
    if t_end is None:
        t_end = (float(ts[-1]) if ts is not None
                 else (seg_v.shape[2] - 1) * float(proto_dt))
    t_dev = _time_on(seg_v.device, t_end)
    outs = []
    for b in range(seg_v.shape[0]):
        recs = fused_nnf_popsweep_solve_ft(
            nets, rgate, seg_v[b], t_dev, proto_dt=proto_dt, t_end=t_end,
            rtol=rtol, atol=atol, trips=trips, base_hh=base_hh, y0=y0,
            return_records=True, cull=cull, mxu_bf16=mxu_bf16,
            q_split=q_split)
        y0 = recs.final_state(t_end)
        if consume is not None:
            consume(b, recs)
        else:
            outs.append(recs.evaluate(ts))
        del recs          # the next segment reuses its record buffers
    return (None if consume is not None else torch.stack(outs)), y0


# ---------------------------------------------------------------------------
# B4: the population solve (P member nets on ONE shared protocol)
# ---------------------------------------------------------------------------


def _pop_setup(nets, rgate, proto_v, ts, proto_t0, proto_dt, t_end, rtol,
               atol, trips) -> _Setup:
    _check_f32("proto_v", proto_v, 1)
    layers = _layers(nets)
    dev = proto_v.device
    _check_layers(layers, member_axis=True, device=dev)
    p = layers[0][0].shape[0]
    if p > 128:
        raise ValueError(f"the population solve takes at most 128 members "
                         f"(got B={p})")
    if trips % SWEEP_BLOCK:
        raise ValueError(f"trips must be a multiple of {SWEEP_BLOCK}, "
                         f"got {trips}")
    gate, _ = _gate_tuples(rgate, None)
    return _Setup(
        layers=layers, vpad=_pad_knots(proto_v[None]), y0=_rest(p, 1, dev),
        gate=gate, base_a=(), t0=float(proto_t0), dt_knot=float(proto_dt),
        t_end=float(t_end) if t_end is not None else float(ts[-1]),
        rtol=float(rtol), atol=float(atol), trips=int(trips),
        block=SWEEP_BLOCK, cull=False, ring=True)


def _pop(nets, rgate, proto_v, ts, *, proto_t0, proto_dt, t_end, rtol, atol,
         trips, plain):
    s = _pop_setup(nets, rgate, proto_v, ts, proto_t0, proto_dt, t_end, rtol,
                   atol, trips)
    if plain or not proto_v.is_cuda:
        out = _trip_solve_plain(s)
    else:
        out = _trip_solve_cuda(s)
        count_launch(fused_nnf_pop_solve_ft)
    rec_sc, rec_y, rec_k, n_out, alive = out
    ys = _dense_eval_popsweep_ft(rec_sc, rec_y, rec_k, n_out[0], n_out[1],
                                 ts)[:, 0]
    return torch.where(alive[:, 0, None, None], ys,
                       torch.full_like(ys, float("inf")))


def fused_nnf_pop_solve_ft(nets, rgate: HHParams, proto_v: torch.Tensor,
                           ts: torch.Tensor, *, proto_t0: float = 0.0,
                           proto_dt: float = 0.1, t_end: float | None = None,
                           rtol: float = 1e-5, atol: float = 1e-7,
                           trips: int = 2048) -> torch.Tensor:
    """Fixed-trip fused solve of B <= 128 member nets (W [B, i, o],
    b [B, o]) on ONE shared protocol ``proto_v`` [N], from rest: ys
    [B, T, 2].  ``trips`` must be a multiple of 256.  Divergence is isolated
    per member: a divergent net freezes, leaves the shared controller and
    returns inf alone.  CUDA tensors run the kernel (the trip kernel at
    Q = 1, one thread block per member); CPU tensors run
    ``fused_nnf_pop_solve_ft_plain``."""
    return _pop(nets, rgate, proto_v, ts, proto_t0=proto_t0,
                proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                trips=trips, plain=False)


fused_nnf_pop_solve_ft.launches = 0


def fused_nnf_pop_solve_ft_plain(nets, rgate: HHParams,
                                 proto_v: torch.Tensor, ts: torch.Tensor, *,
                                 proto_t0: float = 0.0, proto_dt: float = 0.1,
                                 t_end: float | None = None,
                                 rtol: float = 1e-5, atol: float = 1e-7,
                                 trips: int = 2048) -> torch.Tensor:
    """The plain PyTorch version of ``fused_nnf_pop_solve_ft``, on any
    device."""
    return _pop(nets, rgate, proto_v, ts, proto_t0=proto_t0,
                proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                trips=trips, plain=True)


# ---------------------------------------------------------------------------
# B6: the adaptive while-loop sweep (one shared net x B protocols)
# ---------------------------------------------------------------------------
#
# The first-generation solve.  Unlike the trip solves above it has no
# per-lane death and no blocks: every step is tested against
# ratio = sqrt(max over lanes of mean((err/scale)^2)) and accepted when
# ratio <= 1 and every lane's y1 and the ratio are finite, so one
# non-finite lane rejects every step until max_steps and the whole launch
# evaluates to inf.  Only accepted steps are recorded, at row n_acc; the loop
# runs while t < t_end, fewer than max_steps steps were taken, fewer than
# max_rec were accepted and every state is finite.  n_out = (n_acc, or -n_acc
# when t_end was not reached, and the steps taken).


def _while_solve_plain(s: _Setup, max_steps: int):
    """B6's while loop in PyTorch ops, one host read per step.  Returns
    (rec_sc [max_rec, 2], rec_y [max_rec, 1, B, 2], rec_k [max_rec, 7, 1, B,
    2], n_out int32 [2])."""
    f32 = torch.float32
    dev = s.vpad.device
    rhs_all = _mlp_rhs(s)
    t = torch.tensor(s.t0, dtype=f32, device=dev)
    y = s.y0
    f = rhs_all(t, y)
    h = torch.tensor(s.dt_knot * 10.0, dtype=f32, device=dev)
    up = torch.tensor(_MAXF, dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    rec_sc = torch.zeros((s.trips, 2), dtype=f32, device=dev)
    rec_y = torch.zeros((s.trips, *y.shape), dtype=f32, device=dev)
    rec_k = torch.zeros((s.trips, 7, *y.shape), dtype=f32, device=dev)
    n_acc = n_step = 0
    go = True
    while go:
        h_eff = torch.clamp(torch.minimum(h, s.t_end - t), min=1e-8)
        ks, y1, err = _dp5_attempt(rhs_all, t, y, f, h_eff)
        scale = s.atol + s.rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        ratio = torch.sqrt(torch.max(torch.mean(torch.square(err / scale),
                                                dim=-1)))
        accept = ((ratio <= 1.0) & torch.isfinite(y1).all()
                  & torch.isfinite(ratio))
        t_new = torch.where(accept, t + h_eff, t)
        y_new = torch.where(accept, y1, y)
        factor = _SAFETY * torch.exp(
            -0.2 * torch.log(torch.clamp(ratio, min=1e-10)))
        factor = torch.where(torch.isfinite(factor), factor, _MINF)
        h = h_eff * torch.minimum(torch.clamp(factor, min=_MINF),
                                  torch.where(accept, up, one))
        accepted, before_end, finite = torch.stack([
            accept, t_new < s.t_end, torch.isfinite(y_new).all()]).tolist()
        if accepted:
            rec_sc[n_acc] = torch.stack([t, h_eff])
            rec_y[n_acc] = y
            rec_k[n_acc] = torch.stack(ks)
            n_acc += 1
            f = ks[6]
        t, y = t_new, y_new
        n_step += 1
        go = (before_end and n_step < max_steps and n_acc < s.trips
              and finite)
    ok = not before_end and finite
    n_out = torch.tensor([n_acc if ok else -n_acc, n_step],
                         dtype=torch.int32, device=dev)
    return rec_sc, rec_y, rec_k, n_out


def _while_solve_cuda(s: _Setup, max_steps: int):
    """Launch B6's cooperative while-loop kernel (csrc/fused_solve.cu); the
    same outputs as ``_while_solve_plain``.  Raises on a refused launch;
    never synchronises."""
    from ionflux_torch.ops._build import launch

    dev = s.vpad.device
    b = s.y0.shape[1]
    row_tile = min(MAX_ROW_TILE, b)
    wflat, _, bflat, c_sizes, scal, cluster = _kernel_inputs(s, row_tile)
    rec_sc = torch.empty((s.trips, 2), dtype=torch.float32, device=dev)
    rec_y = torch.empty((s.trips, 1, b, 2), dtype=torch.float32, device=dev)
    rec_k = torch.empty((s.trips, 7, 1, b, 2), dtype=torch.float32,
                        device=dev)
    n_out = torch.empty(2, dtype=torch.int32, device=dev)
    partial = torch.empty((2, -(-b // row_tile), 2), dtype=torch.int32,
                          device=dev)
    launch("fused_solve", "ionflux_while_solve", dev,
            s.vpad.data_ptr(), wflat.data_ptr(), bflat.data_ptr(),
            rec_sc.data_ptr(), rec_y.data_ptr(), rec_k.data_ptr(),
            n_out.data_ptr(), partial.data_ptr(), c_sizes, len(s.layers), b,
            s.vpad.shape[1], row_tile, s.trips, int(max_steps), scal,
            *cluster)
    _while_solve_cuda.last_pass = _pass_info(cluster[0], -(-b // row_tile))
    return rec_sc, rec_y, rec_k, n_out


_while_solve_cuda.last_pass = None


def _while(net, rgate, protos_v, ts, *, proto_t0, proto_dt, t_end, rtol,
           atol, max_steps, max_rec, plain):
    if int(max_steps) < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    s = _sweep_setup(net, rgate, protos_v, ts, proto_t0, proto_dt, t_end,
                     rtol, atol, int(max_rec), None, block=1)
    if plain or not protos_v.is_cuda:
        out = _while_solve_plain(s, int(max_steps))
    else:
        out = _while_solve_cuda(s, int(max_steps))
        count_launch(fused_nnf_solve)
        fused_nnf_solve.last_pass = _while_solve_cuda.last_pass
    rec_sc, rec_y, rec_k, n_out = out
    return _dense_eval_popsweep_ft(rec_sc, rec_y, rec_k, n_out[0],
                                   n_out[0].abs(), ts)[0]


def fused_nnf_solve(net, rgate: HHParams, protos_v: torch.Tensor,
                    ts: torch.Tensor, *, proto_t0: float = 0.0,
                    proto_dt: float = 0.1, t_end: float | None = None,
                    rtol: float = 1e-5, atol: float = 1e-7,
                    max_steps: int = 100_000,
                    max_rec: int = 16384) -> torch.Tensor:
    """Adaptive fused solve of one NN-f net over B <= 128 protocols from
    rest, as a data-dependent while loop on one shared controller: ys
    [B, T, 2].  Inf everywhere if t_end is not reached within ``max_steps``
    steps and ``max_rec`` accepted ones, or if any lane goes non-finite.
    CUDA tensors run the kernel; CPU tensors run
    ``fused_nnf_solve_plain``."""
    return _while(net, rgate, protos_v, ts, proto_t0=proto_t0,
                  proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                  max_steps=max_steps, max_rec=max_rec, plain=False)


fused_nnf_solve.launches = 0
fused_nnf_solve.last_pass = None      # the last launch's layer pass


def fused_nnf_solve_plain(net, rgate: HHParams, protos_v: torch.Tensor,
                          ts: torch.Tensor, *, proto_t0: float = 0.0,
                          proto_dt: float = 0.1, t_end: float | None = None,
                          rtol: float = 1e-5, atol: float = 1e-7,
                          max_steps: int = 100_000,
                          max_rec: int = 16384) -> torch.Tensor:
    """The plain PyTorch version of ``fused_nnf_solve``, on any device."""
    return _while(net, rgate, protos_v, ts, proto_t0=proto_t0,
                  proto_dt=proto_dt, t_end=t_end, rtol=rtol, atol=atol,
                  max_steps=max_steps, max_rec=max_rec, plain=True)
