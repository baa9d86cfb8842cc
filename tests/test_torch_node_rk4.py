"""ops/node_rk4.py (the neural-ODE trainer's fused RK4 solve and its
vector-Jacobian product) and the trainer's choice of path.

On the CPU: the size rule, the pack and gradient layouts against
``ops/fused_solve.py::_cluster_pack``, the plain backward (the kernel's
algorithm with no autograd) against autograd through ``solver/fixed.py::
_interval``, and the trainer's counter off the card.  On the card (marked
``cuda``): the fused update against the eager one (``graph=False``) at the
published width.  This file imports no JAX, so the card's tests run where
JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_node_rk4.py
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from ionflux_torch import protocols as TP
from ionflux_torch.models.registry import HH_B06
from ionflux_torch.ops import fused_solve as TK
from ionflux_torch.ops import node_rk4 as NR
from ionflux_torch.solver.fixed import odeint_rk4
from ionflux_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import _node_reference as R  # noqa: E402
import train_neural_ode_torch as NO  # noqa: E402

PUBLISHED = (2, 200, 200, 200, 200, 200, 200, 1)   # nnf_init's 2-200x5-1
SMALL = (2, 16, 16, 1)                              # the card tests' nets
# float32 against autograd in float32 through the same solve: the two
# differ only in the order of the sums (measured 3.3e-7 on the small net
# across the 1000 ms step edge)
PLAIN_F32_TOL = 1e-5


def _leaves(sizes, seed=0, std=0.3, dtype=torch.float32, device="cpu"):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(s * rs.randn(*shape)).to(dtype).to(device)
            for a, b in zip(sizes[:-1], sizes[1:])
            for s, shape in ((std, (a, b)), (0.01, (b,)))]


def _protocol(dtype=torch.float32, device="cpu"):
    pr = TP.activation_protocol(20.0, dt_ms=1.0, device=device)
    return TP.Protocol(pr.t0.to(dtype), pr.dt.to(dtype), pr.v.to(dtype))


def test_size_rule_takes_the_published_and_test_nets():
    """The cluster takes the card tests' 2-16-16-1 net at C = 8 and the
    published 2-200x5-1 net at C = 16 (212 KB a block), and no
    net whose slices cannot fit, nor one with a hidden layer packed whole;
    off the card the trainer always runs eagerly."""
    assert NR.node_cluster(SMALL, NO.RK4_SUB) == 8
    assert NR.node_cluster(PUBLISHED, NO.RK4_SUB) == 16
    assert NR.node_smem_bytes(PUBLISHED, 16, NO.RK4_SUB) == 216832
    assert NR.node_smem_bytes(PUBLISHED, 8, NO.RK4_SUB) > 227 * 1024
    for sizes in ((2, 2000, 2000, 1), (2, 16, 2, 1), (3, 16, 1),
                  (2, 16, 16, 2)):
        assert NR.node_cluster(sizes, NO.RK4_SUB) == 0, sizes
    assert NR.node_cluster(SMALL, NR.MAX_SUB + 1) == 0
    leaves = _leaves(SMALL)
    tr = NO.Trainer(list(zip(leaves[0::2], leaves[1::2])), _protocol(),
                    torch.linspace(0.0, 40.0, 5), torch.tensor([0.0, 1.0]),
                    torch.zeros(5), adjoint=False)
    assert not tr.fused and not tr.use_graphs


@pytest.mark.parametrize("sizes", [SMALL, PUBLISHED, (2, 6, 1),
                                   (2, 5, 7, 9, 1)])
@pytest.mark.parametrize("csize", NR.CLUSTER_SIZES)
def test_leaves_pack_and_unpack_bit_for_bit(sizes, csize):
    """The leaves packed by ``pack_index`` equal ``_cluster_pack``'s rows bit
    for bit, and those rows read back through ``grad_index`` (the
    gradient's layout: each parameter from its owner's row) give the
    leaves' layout bit for bit, every position read once."""
    leaves = _leaves(sizes, seed=len(sizes) + csize)
    layers = [(w.unsqueeze(0), b.unsqueeze(0))
              for w, b in zip(leaves[0::2], leaves[1::2])]
    packed, _, stride = TK._cluster_pack(layers, csize)
    flat = torch.cat([torch.zeros(1)] + [x.reshape(-1) for x in leaves])
    assert torch.equal(flat[NR.pack_index(sizes, csize)], packed)
    gidx = NR.grad_index(sizes, csize)
    assert torch.equal(packed.reshape(-1)[gidx], flat[1:])
    assert len(torch.unique(gidx)) == gidx.numel()
    assert int(gidx.max()) < csize * stride


@pytest.mark.parametrize("sizes", [SMALL, PUBLISHED])
def test_trainer_leaves_round_trip_through_the_plan(sizes):
    """The trainer's own leaves through ``Plan.pack`` (the cluster's rows,
    as ``_cluster_pack`` makes them) and ``Plan.unpack`` (as the kernel's
    gradient is read) come back in the leaves' shapes bit for bit."""
    leaves = _leaves(sizes, seed=3, std=0.1)
    tr = NO.Trainer(list(zip(leaves[0::2], leaves[1::2])), _protocol(),
                    torch.linspace(0.0, 40.0, 5), torch.tensor([0.0, 1.0]),
                    torch.zeros(5), adjoint=False)
    plan = NR.Plan(sizes, NO.RK4_SUB, HH_B06, "cpu")
    flat = [p.detach() for p in tr.flat]
    packed = plan.pack(flat)
    assert torch.equal(packed, TK._cluster_pack(
        [(w.unsqueeze(0), b.unsqueeze(0))
         for w, b in zip(flat[0::2], flat[1::2])], plan.csize)[0])
    out = plan.unpack(packed)
    assert [x.shape for x in out] == [x.shape for x in flat]
    assert all(torch.equal(a, b) for a, b in zip(out, flat))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, PLAIN_F32_TOL)])
def test_plain_vjp_matches_autograd_through_interval(dtype, tol):
    """``vjp_plain`` (the substep recompute and the explicit reverse pass,
    no autograd) against autograd through ``odeint_rk4``'s ``_interval``
    over four intervals of the act protocol across its 1000 ms step edge:
    each leaf within ``tol`` of its norm; ``forward_plain`` equals the
    solve bit for bit; through ``NodeRK4`` on the CPU the same numbers."""
    leaves = _leaves(SMALL, seed=1, dtype=dtype)
    pr = _protocol(dtype)
    ts = torch.linspace(990.0, 1030.0, 5, dtype=dtype)
    y0 = torch.tensor([0.1, 0.9], dtype=dtype)
    g_ys = torch.from_numpy(np.random.RandomState(2).randn(5, 2)).to(dtype)
    layers = list(zip(leaves[0::2], leaves[1::2]))
    ys, starts = NR.forward_plain(layers, pr, ts, y0, NO.RK4_SUB, HH_B06)
    lv = [x.clone().requires_grad_(True) for x in leaves]
    ys_ref = odeint_rk4(NO.rhs, y0, ts, (list(zip(lv[0::2], lv[1::2])), pr),
                        n_sub=NO.RK4_SUB)
    assert torch.equal(ys, ys_ref.detach())
    ref = torch.autograd.grad(ys_ref, lv, g_ys)
    got = NR.vjp_plain(layers, pr, ts, starts, g_ys, NO.RK4_SUB, HH_B06)
    for a, b in zip(got, ref):
        assert float((a - b).norm() / b.norm()) <= tol
    plan = NR.Plan(SMALL, NO.RK4_SUB, HH_B06, "cpu")
    lv = [x.clone().requires_grad_(True) for x in leaves]
    ys_f = NR.node_rk4(plan, pr, ts, y0, lv)
    assert torch.equal(ys_f, ys)
    for a, b in zip(torch.autograd.grad(ys_f, lv, g_ys), got):
        assert torch.equal(a, b)


def test_counter_reads_zero_on_the_cpu_eager_path():
    """An eager update off the card records node.fused_intervals = 0 inside
    its node.step span."""
    leaves = _leaves(SMALL, std=0.1)
    tr = NO.Trainer(list(zip(leaves[0::2], leaves[1::2])), _protocol(),
                    torch.linspace(0.0, 40.0, 5), torch.tensor([0.0, 1.0]),
                    torch.full((5,), 0.5), adjoint=False)
    t0 = time.time_ns()
    tr.step()
    (top,) = [s for s in timing.spans()
              if s.name == "node.step" and s.start_ns >= t0]
    (c,) = [c for c in timing.counts() if c.root == top.id
            and c.name == "node.fused_intervals"]
    assert c.value == 0 and c.span == top.id


def test_float64_reference_matches_the_eager_update_on_the_cpu():
    """The card tests' float64 reference (the plain versions and Adam in
    float64) against three eager float32 updates of the small net on the
    CPU, at the limits the fused update is held to on the card (read
    4.7e-8, 2.9e-7, 1.6e-5)."""
    leaves = _leaves(SMALL, seed=4, std=0.3)
    ts = torch.linspace(0.0, 40.0, 5)
    data = 0.5 + 0.1 * torch.from_numpy(
        np.random.RandomState(5).randn(5).astype(np.float32))
    tr = NO.Trainer(list(zip(leaves[0::2], leaves[1::2])), _protocol(), ts,
                    torch.tensor([0.0, 1.0]), data, adjoint=False)
    losses = [float(tr.step())]
    first = [p.grad.detach().clone() for p in tr.flat]
    losses += [float(tr.step()) for _ in range(2)]
    ref = R.f64_reference(tr, leaves, 3)
    assert ref[3].shape == (5, 2) and ref[3].dtype == torch.float64
    got = R.gaps((losses, first, tr.flat), ref, leaves)
    assert all(g <= t for g, t in zip(
        got, (R.F64_LOSS_RTOL, R.F64_GRAD_TOL, R.F64_CHANGE_TOL))), got


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# The fused update's tolerances against the float64 reference and the
# eager update, and their readings: tests/_node_reference.py.
MAX_KERNELS = 100


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _kernels(call) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("n_t,t_end", [(5, 40.0), (301, 3000.0)])
def test_fused_update_matches_the_eager_update_on_card(card, n_t, t_end):
    """The published net (std 0.1) on the act protocol: three fused updates
    against three eager ones (``graph=False``) and against the float64
    reference: each loss, each leaf's first gradient, the net's change
    after the third; node.fused_intervals reads the intervals; a profiled
    fused update runs under 100 kernels."""
    leaves = _leaves(PUBLISHED, seed=4, std=0.1, device=card)
    layers = list(zip(leaves[0::2], leaves[1::2]))
    proto = _protocol(device=card)
    ts = torch.linspace(0.0, t_end, n_t, device=card)
    y0 = torch.tensor([0.0, 1.0], device=card)
    data = (0.5 + 0.1 * torch.from_numpy(
        np.random.RandomState(5).randn(n_t).astype(np.float32))).to(card)
    runs, trainers = {}, {}
    for graph in (True, False):
        tr = NO.Trainer(layers, proto, ts, y0, data, adjoint=False,
                        graph=graph)
        t0 = time.time_ns()
        losses = [float(tr.step())]
        first = [p.grad.detach().clone() for p in tr.flat]
        losses += [float(tr.step()) for _ in range(2)]
        counts = [c.value for c in timing.counts()
                  if c.name == "node.fused_intervals" and c.ns >= t0]
        assert tr.fused == graph
        assert counts == [n_t - 1 if graph else 0] * 3
        runs[graph], trainers[graph] = (losses, first, tr.flat), tr
    ref = R.f64_reference(trainers[True], leaves, 3)
    to_f64 = R.gaps(runs[True], ref, leaves)
    eager = runs[False]
    to_eager = R.gaps(runs[True], (eager[0], eager[1],
                                   [p.detach() - x for p, x in
                                    zip(eager[2], leaves)]), leaves)
    assert all(g <= t for g, t in zip(
        to_f64, (R.F64_LOSS_RTOL, R.F64_GRAD_TOL, R.F64_CHANGE_TOL))), to_f64
    assert all(g <= t for g, t in zip(
        to_eager, (R.EAGER_LOSS_RTOL, R.EAGER_GRAD_TOL,
                   R.EAGER_CHANGE_TOL))), to_eager
    n_kernels = _kernels(trainers[True].step)
    assert n_kernels < MAX_KERNELS, n_kernels
