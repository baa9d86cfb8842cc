"""Neural-ODE training through a fixed-step RK4 solve of NN-f, as two
hand-written kernels (``csrc/node_rk4.cu``): the solve's forward pass and
its vector-Jacobian product, one launch each, on a thread-block cluster that
holds the net's weights in shared memory.

``NodeRK4`` is the ``torch.autograd.Function``: forward ``node_fwd`` (ys
[T, 2] and every substep's starting state), backward ``node_vjp`` (every
leaf's gradient for a cotangent of ys).  The arithmetic is
``solver/fixed.py::odeint_rk4`` of ``nnf_rhs`` on a protocol with
``n_sub`` substeps an output interval (what
``scripts/train_neural_ode_torch.py`` differentiates), in float32; only the
MLP's sum order differs from PyTorch's.  On CPU tensors the Function runs
the plain versions here (``forward_plain``, ``vjp_plain``: the same
algorithm in PyTorch, the backward with no autograd); on CUDA tensors the
kernels, or it raises.

The size rule is ``node_cluster``; the weights are packed as
``ops/fused_solve.py::_cluster_pack`` packs them for ``mlp_cluster``
(``pack_index``), and the kernel returns the gradient in that layout, each
parameter in its owner block's row (``grad_index``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch.models.nn import LEAKY_SLOPE
from ionflux_torch.models.registry import NETSCALE, VRANGE, HHParams
from ionflux_torch.ops._build import count_launch, launch
from ionflux_torch.ops.fused_solve import (CLUSTER_COLS, _SMEM_BYTES,
                                           _SMEM_STATIC, _cluster_pack,
                                           _round_up, cluster_geometry)

CLUSTER_SIZES = (8, 16)   # the cluster sizes the kernels take, smallest first
MAX_SUB = 64              # substeps an interval (the stage-voltage buffer)
BATCH = 4                 # substeps node_vjp recomputes together (kBatch)
_MAX_LAYERS = 16


def _own(sizes, csize: int) -> list[int]:
    """The partition of each layer's outputs over the cluster's blocks (all
    but the last layer): a hidden layer's slice width, and for layer 0
    ceil(out / csize) rounded up to CLUSTER_COLS (csrc/node_rk4.cu)."""
    geom, _ = cluster_geometry(sizes, csize)
    return [_round_up(-(-sizes[1] // csize), CLUSTER_COLS) if l == 0
            else geom[l][1] for l in range(len(sizes) - 2)]


def node_smem_bytes(sizes, csize: int, n_sub: int) -> int:
    """Dynamic shared memory of a block of the vector-Jacobian product (the
    larger of the two launches), as csrc/node_rk4.cu's ``offsets`` lays it
    out: the weight row and the interval's gradient row, every layer's
    input for the 4 stages of BATCH substeps, the stages' own cotangents, a
    reduce buffer a layer and two scalar buffers, the stage voltages and
    substep states."""
    n_layers = len(sizes) - 1
    _, stride = cluster_geometry(sizes, csize)
    wmax = max(sizes[:-1])
    cmax = max(_own(sizes, csize) + [1])
    return 4 * (2 * stride + 4 * n_layers * wmax * BATCH
                + 4 * n_layers * cmax + n_layers * csize * cmax + 2 * csize
                + 6 * n_sub)


def node_cluster(sizes, n_sub: int) -> int:
    """The size rule of the fused neural-ODE update: the smallest cluster
    size in CLUSTER_SIZES whose blocks hold their slices, gradient rows and
    buffers in the shared memory a block may take, for an NN-f net of 2
    inputs, one output and hidden layers at least 3 wide (a 2-wide layer
    is packed whole, not sliced), at most 16 layers and 256 columns a block,
    and n_sub <= MAX_SUB; 0 where none fits (the trainer's graphs then)."""
    sizes = [int(x) for x in sizes]
    if (len(sizes) < 3 or len(sizes) - 1 > _MAX_LAYERS or sizes[0] != 2
            or sizes[-1] != 1 or min(sizes[1:-1]) < 2
            or min(sizes[2:-1], default=3) < 3 or not 1 <= n_sub <= MAX_SUB):
        return 0
    for csize in CLUSTER_SIZES:
        if (max(_own(sizes, csize)) <= 256 and node_smem_bytes(
                sizes, csize, n_sub) <= _SMEM_BYTES - _SMEM_STATIC):
            return csize
    return 0


def pack_index(sizes, csize: int, device=None) -> torch.Tensor:
    """[csize, stride] int64 positions into ``[0] + cat(leaves)`` (each leaf
    flattened) that give ``_cluster_pack``'s rows: position 0, the zero, in
    every padding.  Built by packing the leaves' own positions (exact in
    float32 up to 2^24 parameters)."""
    n = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    if n >= 1 << 24:
        raise ValueError("pack_index: more than 2^24 parameters")
    pos, layers = 1, []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        w = torch.arange(pos, pos + d_in * d_out, dtype=torch.float32)
        pos += d_in * d_out
        b = torch.arange(pos, pos + d_out, dtype=torch.float32)
        pos += d_out
        layers.append((w.reshape(1, d_in, d_out), b.reshape(1, d_out)))
    packed, _, _ = _cluster_pack(layers, csize)
    return packed.to(torch.int64).to(device)


def grad_index(sizes, csize: int, device=None) -> torch.Tensor:
    """[n] int64 positions into the kernel's flattened [csize, stride]
    gradient, one per parameter in the leaves' order (W0, b0, W1, ...):
    each parameter in the row of the block that owns it: a hidden layer's
    column by its slice, layer 0's column by ``_own``'s partition, the last
    layer's input row k by the partition of the layer before, its bias at
    rank 0 (csrc/node_rk4.cu's ``grad_update``)."""
    geom, stride = cluster_geometry(sizes, csize)
    own = _own(sizes, csize)
    last = len(sizes) - 2
    out = []
    for l, ((d_in, d_out), (off, cols)) in enumerate(
            zip(zip(sizes[:-1], sizes[1:]), geom)):
        k = np.arange(d_in)[:, None]
        j = np.arange(d_out)[None, :]
        if l == last:         # [in, 1]: row k by the partition of layer l-1
            rank = np.arange(d_in)[:, None] // own[l - 1]
            w = rank * stride + off + k
            b = np.array([off + d_in])
        elif l == 0:          # whole: column j by its owner
            rank = j // own[0]
            w = rank * stride + off + k * cols + j
            b = (rank * stride + off + d_in * cols + j)[0]
        else:                 # sliced: column j in rank j // cols's slice
            rank, c = j // cols, j % cols
            w = rank * stride + off + k * cols + c
            b = (rank * stride + off + d_in * cols + c)[0]
        out += [np.broadcast_to(w, (d_in, d_out)).reshape(-1), b.reshape(-1)]
    return torch.as_tensor(np.concatenate(out), dtype=torch.int64,
                           device=device)


class Plan:
    """What the two launches take for one net shape on one device: the
    cluster size (``node_cluster``), the geometry, the pack and gradient
    indices, the r-gate and the substeps.  ``pack(leaves)`` gives the
    packed rows (two kernels: a cat and a gather), ``unpack(grad)`` the
    leaves' gradients (one gather, then views)."""

    def __init__(self, sizes, n_sub: int, rgate: HHParams, device):
        self.sizes = [int(x) for x in sizes]
        self.n_sub = int(n_sub)
        self.rgate = rgate
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.csize = node_cluster(self.sizes, self.n_sub)
        self.shapes = [s for a, b in zip(self.sizes[:-1], self.sizes[1:])
                       for s in ((a, b), (b,))]
        if not self.csize:
            if self.device.type == "cuda":
                raise ValueError(f"node_rk4: the cluster takes no net of "
                                 f"sizes {self.sizes} at n_sub {self.n_sub}")
            return
        geom, self.stride = cluster_geometry(self.sizes, self.csize)
        self.geom = (ctypes.c_int * (2 * len(geom)))(*sum(geom, ()))
        self.c_sizes = (ctypes.c_int * len(self.sizes))(*self.sizes)
        f = np.float32
        self.scal = (ctypes.c_float * 5)(
            *(f(float(x)) for x in tuple(rgate)[4:8]), f(P.HOLDING_MV))
        self.pidx = pack_index(self.sizes, self.csize, self.device)
        self.gidx = grad_index(self.sizes, self.csize, self.device)
        self.zero = torch.zeros(1, dtype=torch.float32, device=self.device)

    def pack(self, leaves) -> torch.Tensor:
        flat = torch.cat([self.zero] + [x.reshape(-1) for x in leaves])
        return flat[self.pidx]

    def unpack(self, grad: torch.Tensor) -> list[torch.Tensor]:
        flat = grad.reshape(-1)[self.gidx]
        parts = flat.split([int(np.prod(s)) for s in self.shapes])
        return [p.view(s) for p, s in zip(parts, self.shapes)]


def _check(name, x, shape, device) -> None:
    if (x.dtype != torch.float32 or x.device != device
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(f"node_rk4: {name} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _launch_args(plan: Plan, proto: P.Protocol, ts: torch.Tensor):
    for name, x, shape in (("ts", ts, ts.shape), ("proto.v", proto.v,
                                                  proto.v.shape),
                           ("proto.t0", proto.t0, ()), ("proto.dt", proto.dt,
                                                         ())):
        _check(name, x, shape, plan.device)
    if ts.dim() != 1 or ts.shape[0] < 2 or proto.v.dim() != 1:
        raise ValueError("node_rk4: ts [T >= 2] and one protocol's knots")
    return (proto.v.data_ptr(), proto.t0.data_ptr(), proto.dt.data_ptr(),
            proto.v.shape[0], ts.data_ptr())


def _fwd_cuda(plan: Plan, proto, ts, y0, packed):
    """ys [T, 2] and the substeps' starting states [T - 1, n_sub, 2] by
    node_fwd on the tensors' device and current stream; never
    synchronises."""
    _check("y0", y0, (2,), plan.device)
    _check("packed", packed, (plan.csize, plan.stride), plan.device)
    n_t = ts.shape[0]
    ys = torch.empty((n_t, 2), dtype=torch.float32, device=plan.device)
    ystart = torch.empty((n_t - 1, plan.n_sub, 2), dtype=torch.float32,
                         device=plan.device)
    knots, pt0, pdt, n_knots, tsp = _launch_args(plan, proto, ts)
    launch("node_rk4", "ionflux_node_rk4_fwd", plan.device,
           packed.data_ptr(), knots, pt0, pdt, n_knots, tsp, n_t,
           y0.data_ptr(), ys.data_ptr(), ystart.data_ptr(), plan.c_sizes,
           len(plan.sizes) - 1, plan.csize, plan.geom, plan.stride,
           plan.n_sub, plan.scal)
    count_launch(_fwd_cuda)
    return ys, ystart


def _vjp_cuda(plan: Plan, proto, ts, ystart, g_ys, packed):
    """The gradient [csize, stride] in the packed layout by node_vjp on the
    tensors' device and current stream; never synchronises."""
    n_t = ts.shape[0]
    _check("ystart", ystart, (n_t - 1, plan.n_sub, 2), plan.device)
    _check("g_ys", g_ys, (n_t, 2), plan.device)
    _check("packed", packed, (plan.csize, plan.stride), plan.device)
    grad = torch.empty_like(packed)
    knots, pt0, pdt, n_knots, tsp = _launch_args(plan, proto, ts)
    launch("node_rk4", "ionflux_node_rk4_vjp", plan.device,
           packed.data_ptr(), knots, pt0, pdt, n_knots, tsp, n_t,
           ystart.data_ptr(), g_ys.data_ptr(), grad.data_ptr(), plan.c_sizes,
           len(plan.sizes) - 1, plan.csize, plan.geom, plan.stride,
           plan.n_sub, plan.scal)
    count_launch(_vjp_cuda)
    return grad


_fwd_cuda.launches = 0
_vjp_cuda.launches = 0


# ---------------------------------------------------------------------------
# The plain versions: the kernels' algorithm in PyTorch on the leaves
# ---------------------------------------------------------------------------

def _rates(rgate: HHParams, v):
    k3 = float(rgate.p5) * torch.exp(float(rgate.p6) * v)
    k4 = float(rgate.p7) * torch.exp(-float(rgate.p8) * v)
    return k3, k4


def _stage(layers, rgate, proto, t, u):
    """f(t, u) of NN-f, keeping what the reverse pass needs: every layer's
    input xs[l] and the r-gate's rates."""
    v = P.voltage(proto, t)
    x = torch.stack([v / VRANGE, u[0]])
    xs = [x]
    for w, b in layers[:-1]:
        z = x @ w + b
        x = torch.where(z >= 0, z, LEAKY_SLOPE * z)
        xs.append(x)
    w, b = layers[-1]
    out = x @ w + b
    k3, k4 = _rates(rgate, v)
    k = torch.stack([out[0] / NETSCALE, -k3 * u[1] + k4 * (1.0 - u[1])])
    return k, xs, (k3, k4)


def forward_plain(layers, proto: P.Protocol, ts, y0, n_sub: int,
                  rgate: HHParams):
    """(ys [T, 2], ystart [T - 1, n_sub, 2]): the RK4 solve as
    ``solver/fixed.py::_interval`` computes it, op for op, and each
    substep's starting state."""
    from ionflux_torch.models.nn import NNfParams, nnf_rhs
    from ionflux_torch.solver.fixed import _rk4_step

    p = NNfParams(layers, rgate)

    def rhs(t, y):
        return nnf_rhs(p, t, y, P.voltage(proto, t))

    ts = ts.to(y0.dtype)
    ys, starts, y = [y0], [], y0
    for k in range(ts.shape[0] - 1):
        t0, t1 = ts[k], ts[k + 1]
        h = (t1 - t0) / n_sub
        for i in range(n_sub):
            starts.append(y)
            y = _rk4_step(rhs, t0 + i * h, y, h)
        ys.append(y)
    return (torch.stack(ys),
            torch.stack(starts).reshape(ts.shape[0] - 1, n_sub, -1))


def vjp_plain(layers, proto: P.Protocol, ts, ystart, g_ys, n_sub: int,
              rgate: HHParams) -> list[torch.Tensor]:
    """Every leaf's gradient (W0, b0, W1, ...) of <g_ys, ys> by the
    kernel's algorithm, with no autograd: the intervals last first; each
    substep recomputed from its starting state, then its reverse pass,
    stages 4..1 (the LeakyReLU derivative, the transposed products, the
    r-gate's linear cotangent, RK4's stage cotangents); each interval's
    parameter gradient summed and added into the total; g_ys[k] added at
    each output boundary."""
    ts = ts.to(ystart.dtype)
    total = [torch.zeros_like(x) for pair in layers for x in pair]
    g = g_ys[-1]
    for k in range(ts.shape[0] - 2, -1, -1):
        t0, t1 = ts[k], ts[k + 1]
        h = (t1 - t0) / n_sub
        acc = [torch.zeros_like(x) for x in total]
        for i in range(n_sub - 1, -1, -1):
            y, t = ystart[k, i], t0 + i * h
            times = (t, t + 0.5 * h, t + 0.5 * h, t + h)
            coef = (None, 0.5 * h, 0.5 * h, h)
            stages, prev = [], None
            for s in range(4):
                u = y if s == 0 else y + coef[s] * prev
                prev, xs, rates = _stage(layers, rgate, proto, times[s], u)
                stages.append((xs, rates))
            gs = (h / 6.0) * g
            gk = [gs, 2.0 * gs, 2.0 * gs, gs]
            gy = g
            for s in range(3, -1, -1):
                xs, (k3, k4) = stages[s]
                gu = _mlp_rate_vjp(layers, xs, gk[s], k3, k4, acc)
                gy = gy + gu
                if s > 0:
                    gk[s - 1] = gk[s - 1] + gu * coef[s]
            g = gy
        total = [a + b for a, b in zip(total, acc)]
        g = g + g_ys[k]
    return total


def _mlp_rate_vjp(layers, xs, gk, k3, k4, acc):
    """The cotangent of a stage's state u for the cotangent gk of f(t, u):
    the MLP's reverse pass for da/dt (its parameter gradients added into
    acc) and the r-gate's scalar derivative for dr/dt."""
    n = len(layers)
    dz = gk[0] / NETSCALE                       # the last layer's output
    w, _ = layers[-1]
    acc[2 * n - 2] += torch.outer(xs[-1], dz.reshape(1))
    acc[2 * n - 1] += dz.reshape(1)
    dx = w[:, 0] * dz
    for l in range(n - 2, -1, -1):
        w, _ = layers[l]
        dz = torch.where(xs[l + 1] >= 0, dx, dx * LEAKY_SLOPE)
        acc[2 * l] += torch.outer(xs[l], dz)
        acc[2 * l + 1] += dz
        dx = w @ dz
    gr = gk[1] * -k3 - gk[1] * k4
    return torch.stack([dx[1], gr])


class NodeRK4(torch.autograd.Function):
    """ys [T, 2] of NN-f (``leaves``: W0, b0, W1, ...) on ``proto`` at
    ``ts`` from ``y0`` by RK4 with ``plan.n_sub`` substeps an interval,
    differentiable in the leaves.  CUDA: node_fwd, node_vjp (one launch
    each, plus the pack and the unpack); CPU: the plain versions."""

    @staticmethod
    def forward(ctx, plan: Plan, proto, ts, y0, *leaves):
        cuda = ts.device.type == "cuda"
        if cuda:
            packed = plan.pack(leaves)
            ys, ystart = _fwd_cuda(plan, proto, ts, y0, packed)
            ctx.save_for_backward(ts, ystart, packed)
        else:
            layers = list(zip(leaves[0::2], leaves[1::2]))
            ys, ystart = forward_plain(layers, proto, ts, y0, plan.n_sub,
                                       plan.rgate)
            ctx.save_for_backward(ts, ystart, *leaves)
        ctx.plan, ctx.proto, ctx.cuda = plan, proto, cuda
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        plan, proto = ctx.plan, ctx.proto
        ts, ystart, *rest = ctx.saved_tensors
        g_ys = g_ys.contiguous()
        if ctx.cuda:
            grads = plan.unpack(_vjp_cuda(plan, proto, ts, ystart, g_ys,
                                          rest[0]))
        else:
            layers = list(zip(rest[0::2], rest[1::2]))
            grads = vjp_plain(layers, proto, ts, ystart, g_ys, plan.n_sub,
                              plan.rgate)
        return (None, None, None, None, *grads)


def node_rk4(plan: Plan, proto: P.Protocol, ts: torch.Tensor,
             y0: torch.Tensor, leaves) -> torch.Tensor:
    """ys [T, 2] by ``NodeRK4`` (see there)."""
    return NodeRK4.apply(plan, proto, ts, y0, *leaves)

