"""ionflux_torch as a package: it imports neither JAX nor ionflux, its entry
points never drop to the CPU unasked, its fused-solve wrappers refuse what
the kernels do not take, and (on a card) each CUDA kernel agrees with its
plain PyTorch version.

This file imports no JAX, so the card's tests run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_package.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ionflux_torch import protocols as TP
from ionflux_torch import protorec as TRec
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.ops import bias_probe as TB
from ionflux_torch.ops import fused_solve as TK
from ionflux_torch.ops import hh_solve as TH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(seed=0, members=None, sizes=(2, 16, 16, 1), device="cpu"):
    rs = np.random.RandomState(seed)
    lead = () if members is None else (members,)
    return [(torch.from_numpy((0.1 * rs.randn(*lead, a, b)).astype(
                np.float32)).to(device),
             torch.from_numpy((0.01 * rs.randn(*lead, b)).astype(
                 np.float32)).to(device))
            for a, b in zip(sizes[:-1], sizes[1:])]


def _protos(levels=(-40.0, 20.0), device="cpu"):
    return TP.stack([TP.activation_protocol(v, 1.0, device=device)
                     for v in levels]).v


def test_port_imports_neither_jax_nor_ionflux():
    """Every module of the port, chip_smoke.py, every scripts/*_torch.py
    and the stand-in writer and rank functions of the replay and
    multi-process tests, imported in a fresh interpreter: neither jax nor
    ionflux (nor matplotlib) is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ionflux_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ionflux_torch.__path__, 'ionflux_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for n in ('models.markov', 'protorec', 'solver.chained',\n"
        "          'ops.hh_solve', 'ops._build', 'fit.cmaes',\n"
        "          'ops.fused_solve', 'ops.bias_probe', 'models.gt_a',\n"
        "          'studies', 'surface', 'data', 'fit.train',\n"
        "          'ops.smoothing', 'solver.batched', 'solver.analytic',\n"
        "          'native', 'ops.spline', 'ops.sym_eig', 'solver.fixed',\n"
        "          'solver.adams', 'solver.vcabm', 'solver.implicit',\n"
        "          'solver.adjoint', 'figures', 'utils.timing',\n"
        "          'parallel', 'parallel.mesh', 'parallel.multihost',\n"
        "          'entry'):\n"
        "    assert 'ionflux_torch.' + n in names, n\n"
        "import chip_smoke, glob, os\n"
        "sys.path[:0] = ['scripts', 'tests']\n"
        "scripts = sorted(os.path.basename(f)[:-3]\n"
        "                 for f in glob.glob('scripts/*_torch.py'))\n"
        "for n in scripts + ['_r_replay_standins', '_multiproc_workers',\n"
        "          '_node_reference']:\n"
        "    importlib.import_module(n)\n"
        "assert {'table_2_torch', 'table_s1_torch', 'figure_4_torch',\n"
        "        'figure_4_s_torch', 'figure_5_torch', 'figure_6_torch',\n"
        "        'figure_7_torch', 'figure_supplements_torch',\n"
        "        'train_d0_torch', 'table_1_torch'} <= set(scripts)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ionflux', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_refuse_the_cpu_unless_asked():
    """Without a card, functions that make tensors from nothing raise unless
    given device='cpu'; functions that take tensors follow their device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from ionflux_torch.entry import entry
    from ionflux_torch.utils.ckpt import load_pytree

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import train_d0_torch as T0
    finally:
        sys.path.pop(0)
    d1 = os.path.join(ROOT, "out", "d1", "model.npz")
    for call in (entry,
                 lambda: TP.activation_protocol(20.0),
                 lambda: TP.deactivation_family(1.0),
                 lambda: TP.from_time_series(np.arange(3.0), np.zeros(3)),
                 lambda: TRec.protocol("pr3-cell5"),
                 T0.generate_data,
                 lambda: T0._sweep_protos("pr5-cell5"),
                 lambda: T0.make_objective_fused(np.zeros(1), np.zeros(1), 8),
                 lambda: load_pytree(d1, "nnf"),
                 lambda: TN.nnf_init(torch.Generator().manual_seed(0),
                                     TR.HH_B06, 1, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fn, args = entry(device="cpu")
    assert args[2].device.type == "cpu"
    assert TRec.protocol("pr4-cell5", device="cpu").v.device.type == "cpu"
    # CPU tensors take the plain version: no kernel launch is counted
    counted = (TK.fused_nnf_solve_ft, TK.fused_nnf_popsweep_solve_ft,
               TK.fused_nnf_solve, TB.bias_probe)
    before = [k.launches for k in counted]
    ys = TK.fused_nnf_solve_ft(_net(), TR.HH_B06, _protos(),
                               torch.tensor([0.0, 4000.0]), proto_dt=1.0,
                               trips=1024)
    assert ys.device.type == "cpu" and bool(torch.isfinite(ys).all())
    ys = TK.fused_nnf_solve(_net(), TR.HH_B06, _protos(),
                            torch.tensor([0.0, 4000.0]), proto_dt=1.0)
    assert ys.device.type == "cpu" and bool(torch.isfinite(ys).all())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _probe_script().main("fold")
    assert _probe_script().main("fold", device="cpu").device.type == "cpu"
    assert [k.launches for k in counted] == before


def _probe_script():
    """The port's probe script, imported from scripts/."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import probe_mosaic_bias_fault_torch
    finally:
        sys.path.pop(0)
    return probe_mosaic_bias_fault_torch


def _bad_sweep(case):
    """``case`` names what is wrong; a "while: " prefix sends it to the
    while-loop sweep (fused_nnf_solve) instead of the fixed-trip one."""
    solver, _, case = case.rpartition(": ")
    net, v = _net(), _protos()
    ts = torch.tensor([0.0, 8000.0])
    if solver == "while":
        kw = dict(proto_dt=1.0, max_steps=300, max_rec=256)
        if case in ("max_rec 0", "max_steps 0"):
            kw[case.split()[0]] = 0
    else:
        kw = dict(proto_dt=1.0, trips=300 if case == "trips not whole blocks"
                  else 256)
    if case == "f64 protocols":
        v = v.double()
    elif case == "1-d protocols":
        v = v[0]
    elif case == "int weights":
        net[0] = (net[0][0].int(), net[0][1])
    elif case == "widths do not chain":
        net[1] = (net[1][0][:8], net[1][1])
    elif case == "two outputs":
        net[-1] = (torch.cat([net[-1][0]] * 2, 1), torch.cat([net[-1][1]] * 2))
    elif case == "three inputs":
        net[0] = (torch.cat([net[0][0], net[0][0][:1]]), net[0][1])
    elif case == "129 rows":
        v = v[:1].expand(129, -1)
    fn = TK.fused_nnf_solve if solver == "while" else TK.fused_nnf_solve_ft
    return lambda: fn(net, TR.HH_B06, v, ts, **kw)


@pytest.mark.parametrize("case", [
    "f64 protocols", "1-d protocols", "int weights", "widths do not chain",
    "two outputs", "three inputs", "129 rows", "trips not whole blocks",
    "while: f64 protocols", "while: 1-d protocols", "while: int weights",
    "while: widths do not chain", "while: two outputs",
    "while: three inputs", "while: 129 rows", "while: max_rec 0",
    "while: max_steps 0"])
def test_sweep_wrapper_refuses_bad_inputs(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_sweep(case)()


def _bad_popsweep(case):
    nets, v = _net(members=2), _protos()
    ts = torch.tensor([0.0, 8000.0])
    kw = dict(proto_dt=1.0, trips=256)
    if case == "weights without member axis":
        nets = _net()
    elif case == "members disagree":
        nets[1] = (nets[1][0][:1], nets[1][1][:1])
    elif case == "129 members":
        nets = _net(members=129)
    elif case == "33 rows":
        v = v[:1].expand(33, -1)
    elif case == "y0 shape":
        kw["y0"] = torch.zeros(2, 3, 2)
    elif case == "y0 f64":
        kw["y0"] = torch.zeros(2, 2, 2, dtype=torch.float64)
    elif case == "q_split 3":
        kw["q_split"] = 3
    return lambda: TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, v, ts,
                                                  **kw)


@pytest.mark.parametrize("case", [
    "weights without member axis", "members disagree", "129 members",
    "33 rows", "y0 shape", "y0 f64", "q_split 3"])
def test_popsweep_wrapper_refuses_bad_inputs(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_popsweep(case)()


# --------------------------------------------------------------------------
# On the card (marked cuda; they skip where there is none)
# --------------------------------------------------------------------------

# kernel vs plain: two adaptive f32 solves whose MLP sums run in different
# orders, so a borderline accept can flip and the shared controllers part
CARD_TOL = 5e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close_on_card(ys_k, ys_p):
    fin = torch.isfinite(ys_p)
    assert torch.equal(torch.isfinite(ys_k), fin)
    assert float((ys_k - ys_p)[fin].abs().max()) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("base", [None, "nnd"])
def test_sweep_kernel_matches_plain_on_card(card, base):
    net = _net(sizes=(2, 64, 64, 64, 1), device=card)
    v = _protos((-40.0, 0.0, 20.0), device=card)
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    kw = dict(proto_dt=1.0, trips=2048,
              base_hh=TR.HH_B06 if base else None)
    before = TK.fused_nnf_solve_ft.launches
    ys_k = TK.fused_nnf_solve_ft(net, TR.HH_B06, v, ts, **kw)
    torch.cuda.synchronize()
    assert TK.fused_nnf_solve_ft.launches == before + 1
    ys_p = TK.fused_nnf_solve_ft_plain(net, TR.HH_B06, v, ts, **kw)
    assert TK.fused_nnf_solve_ft.launches == before + 1
    _close_on_card(ys_k, ys_p)


@pytest.mark.cuda
def test_popsweep_kernel_matches_plain_on_card(card):
    """Odd Q, a dead y0 lane and q_split: q_split only changes the rows per
    thread block, so the kernel's result is bit-identical."""
    nets = _net(members=4, sizes=(2, 64, 64, 1), device=card)
    v = _protos((-40.0, 0.0, 20.0), device=card)
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    y0 = torch.zeros(4, 3, 2, device=card)
    y0[..., 1] = 1.0
    y0[2, 1] = float("nan")
    kw = dict(proto_dt=1.0, trips=2048, y0=y0)
    before = TK.fused_nnf_popsweep_solve_ft.launches
    ys_k = TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, v, ts, **kw)
    ys_k2 = TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, v, ts,
                                           q_split=2, **kw)
    torch.cuda.synchronize()
    assert TK.fused_nnf_popsweep_solve_ft.launches == before + 2
    assert torch.equal(ys_k, ys_k2)
    assert bool(torch.isinf(ys_k[2, 1]).all())
    ys_p = TK.fused_nnf_popsweep_solve_ft_plain(nets, TR.HH_B06, v, ts, **kw)
    _close_on_card(ys_k, ys_p)
    # mxu_bf16: bf16 weights in the kernel; at Q = 9 (padded to 16) the
    # biases are rounded to bf16 as well
    for levels in ((-40.0, 0.0, 20.0), tuple(np.linspace(-40.0, 40.0, 9))):
        vq = _protos(levels, device=card)
        kw = dict(proto_dt=1.0, trips=2048, mxu_bf16=True)
        before = TK.fused_nnf_popsweep_solve_ft.launches
        ys_k = TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, vq, ts, **kw)
        torch.cuda.synchronize()
        assert TK.fused_nnf_popsweep_solve_ft.launches == before + 1
        ys_p = TK.fused_nnf_popsweep_solve_ft_plain(nets, TR.HH_B06, vq, ts,
                                                    **kw)
        assert bool(torch.isfinite(ys_p).all())
        _close_on_card(ys_k, ys_p)


def _hh_population(b=16, device="cpu"):
    base = np.array([float(x) for x in TR.HH_B06])
    rs = np.random.RandomState(0)
    return torch.from_numpy((base[None] * np.exp(0.1 * rs.randn(b, 8))
                             ).astype(np.float32)).to(device)


@pytest.mark.cuda
def test_hh_pop_kernel_matches_plain_on_card(card):
    """A y0 carry with a dead lane, and the stiff lane that the pace cull
    reaps alone; b = 40 lanes leaves the second warp partly idle."""
    pop = _hh_population(40, card)
    v = TP.activation_protocol(20.0, 1.0, device=card).v
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    y0 = torch.zeros(40, 2, device=card)
    y0[:, 1] = 1.0
    y0[3] = float("nan")
    kw = dict(proto_dt=1.0, trips=2048, t_end=8000.0, y0=y0)
    before = TH.fused_hh_pop_solve_ft.launches
    ys_k = TH.fused_hh_pop_solve_ft(pop, v, ts, **kw)
    torch.cuda.synchronize()
    assert TH.fused_hh_pop_solve_ft.launches == before + 1
    ys_p = TH.fused_hh_pop_solve_ft_plain(pop, v, ts, **kw)
    assert TH.fused_hh_pop_solve_ft.launches == before + 1
    assert bool(torch.isinf(ys_k[3]).all())
    assert bool(torch.isfinite(ys_k[[0, 1, 2, 4, 39]]).all())
    _close_on_card(ys_k, ys_p)
    pop[1, 1] = 1.0
    ys_k = TH.fused_hh_pop_solve_ft(pop, v, ts, **kw)
    ys_p = TH.fused_hh_pop_solve_ft_plain(pop, v, ts, **kw)
    dead = torch.isinf(ys_k).all(dim=(1, 2)).nonzero().flatten().tolist()
    assert dead == [1, 3]
    _close_on_card(ys_k, ys_p)


@pytest.mark.cuda
def test_hh_rk4_kernel_matches_plain_on_card(card):
    pop = _hh_population(40, card)
    v = TP.activation_protocol(20.0, 1.0, device=card).v
    kw = dict(proto_dt=1.0, dt_out=10.0, n_out=801, n_sub=10, y0=(0.1, 0.9))
    before = TH.fused_hh_rk4.launches
    ys_k = TH.fused_hh_rk4(pop, v, **kw)
    torch.cuda.synchronize()
    assert TH.fused_hh_rk4.launches == before + 1
    ys_p = TH.fused_hh_rk4_plain(pop, v, **kw)
    assert TH.fused_hh_rk4.launches == before + 1
    assert tuple(ys_k.shape) == (40, 801, 2)
    assert bool(torch.isfinite(ys_p).all())
    # no controller and the same f32 operations in the same order
    assert float((ys_k - ys_p).abs().max()) <= 1e-5


# The HH population kernels' Hopper layout (csrc/hh_solve.cu): the trip
# kernel's chain warps and helper warps (G helpers per lane compute the
# rates off the chain) across lane counts that fill one to four chain warps,
# and the RK4 kernel's lanes spread over blocks with producer warps.


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 8, 33, 128])
def test_hh_pop_lane_groups_match_plain_on_card(card, b):
    """The trip kernel at the rule's threads per lane (as the kernel reports
    its launch) against the plain version (5e-3 on the gates, equal executed
    trips), with lane b - 1 dead from the start (NaN y0) where there are two
    lanes or more."""
    pop = _hh_population(b, card)
    v = TP.activation_protocol(20.0, 1.0, device=card).v
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    y0 = torch.zeros(b, 2, device=card)
    y0[:, 1] = 1.0
    if b > 1:
        y0[b - 1] = float("nan")
    kw = dict(proto_t0=0.0, proto_dt=1.0, t_end=8000.0, rtol=1e-5,
              atol=1e-7, trips=2048)
    before = TH.fused_hh_pop_solve_ft.launches
    out_k = TH._hh_pop_solve(pop, v, y0, plain=False, **kw)
    torch.cuda.synchronize()
    assert TH.fused_hh_pop_solve_ft.launches == before + 1
    geo = TH.hh_trip_geometry(b)
    assert TH.fused_hh_pop_solve_ft.last_layout == dict(
        group=geo["group"], threads=geo["threads"],
        chain_warps=geo["chain_warps"])
    out_p = TH._hh_pop_solve(pop, v, y0, plain=True, **kw)
    assert int(out_k[3][1]) == int(out_p[3][1]) and int(out_k[3][0]) > 0
    ys = [TK._dense_eval_ft(*o[:3], o[3][0], o[3][1], ts, lane_ok=o[4])
          for o in (out_k, out_p)]
    if b > 1:
        assert not bool(out_k[4][b - 1]) and bool(torch.isinf(ys[0][b - 1]).all())
        assert bool(out_k[4][:b - 1].all())
    _close_on_card(*ys)


@pytest.mark.cuda
def test_hh_pop_stiff_lane_dies_alone_and_carry_on_card(card):
    """At 128 lanes (four chain warps): a stiff lane (p2 = 1: k1 ~ e^20 at
    +20 mV) is pace-culled alone in kernel and plain version; then a second
    sweep seeded with each version's final states (the y0 carry of the d0
    objective) agrees within 5e-3."""
    pop = _hh_population(128, card)
    pop[1, 1] = 1.0
    v = TP.activation_protocol(20.0, 1.0, device=card).v
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    kw = dict(proto_dt=1.0, trips=2048, t_end=8000.0)
    ys_k = TH.fused_hh_pop_solve_ft(pop, v, ts, **kw)
    ys_p = TH.fused_hh_pop_solve_ft_plain(pop, v, ts, **kw)
    for ys in (ys_k, ys_p):
        dead = torch.isinf(ys).all(dim=(1, 2)).nonzero().flatten().tolist()
        assert dead == [1]
    _close_on_card(ys_k, ys_p)
    v2 = TP.activation_protocol(-40.0, 1.0, device=card).v
    ts_end = torch.cat([ts, torch.tensor([8000.0], device=card)])
    carry = []
    for fn in (TH.fused_hh_pop_solve_ft, TH.fused_hh_pop_solve_ft_plain):
        first = fn(pop, v, ts_end, **kw)
        carry.append(fn(pop, v2, ts, y0=first[:, -1, :].contiguous(), **kw))
    assert bool(torch.isinf(carry[0][1]).all())        # NaN carried: dead
    _close_on_card(*carry)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sub", [1, 10])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_hh_rk4_lane_spread_matches_plain_on_card(card, b, n_sub):
    """The RK4 kernel (producer warps, one consumer thread per lane, lanes
    spread as the kernel reports and the rule says) against the plain
    version within 1e-5."""
    pop = _hh_population(b, card)
    v = TP.activation_protocol(20.0, 1.0, device=card).v[:3001]
    kw = dict(proto_dt=1.0, dt_out=10.0, n_out=301, n_sub=n_sub,
              y0=(0.1, 0.9))
    before = TH.fused_hh_rk4.launches
    ys_k = TH.fused_hh_rk4(pop, v, **kw)
    torch.cuda.synchronize()
    assert TH.fused_hh_rk4.launches == before + 1
    geo = TH.rk4_geometry(b)
    assert TH.fused_hh_rk4.last_layout == dict(
        lanes_per_block=geo["lanes_per_block"], blocks=geo["blocks"],
        threads=geo["threads"])
    ys_p = TH.fused_hh_rk4_plain(pop, v, **kw)
    assert tuple(ys_k.shape) == (b, 301, 2)
    assert bool(torch.isfinite(ys_p).all())
    assert float((ys_k - ys_p).abs().max()) <= 1e-5


def _d0_script():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_d0_torch

    return train_d0_torch


@pytest.mark.cuda
def test_d0_objective_replays_its_graph_bit_for_bit_on_card(card):
    """The d0 objective on two stand-in recordings (3 sweeps of ~2,000 knots
    each): its first call runs eagerly and captures the generation as a CUDA
    graph, every later call replays it; each call's SSE equals the eager
    ``device_fn`` bit for bit and counts one launch per sweep (6; 16 on the
    real Pr3 + Pr5), the capture none."""
    T = _d0_script()
    rs = np.random.RandomState(0)
    recs = []
    for name, period in (("standin-a", 2000), ("standin-b", 1999)):
        cuts = np.linspace(0, period, 6).astype(int)
        v = np.concatenate([np.repeat(
            [-80.0, *rs.uniform(-100.0, 40.0, 3), -80.0], np.diff(cuts))
            for _ in range(3)]).astype(np.float32)
        recs.append((name, v, 1.0, 3, period))
    data = [0.1 * rs.randn(600), 0.1 * rs.randn(600)]
    pop = 8
    objective = T.make_objective_fused(*data, pop, trips=2048, device=card,
                                       recordings=recs)
    for gen in range(3):
        xs = T.P0[None] * np.exp(0.1 * rs.randn(pop, 4))
        before = TH.fused_hh_pop_solve_ft.launches
        f = objective(xs)
        assert TH.fused_hh_pop_solve_ft.launches == before + 6, gen
        assert f.shape == (pop,) and bool(np.isfinite(f).all())
        ref = objective.device_fn(torch.tensor(xs, dtype=torch.float32,
                                               device=card))
        assert TH.fused_hh_pop_solve_ft.launches == before + 12
        assert np.array_equal(f, ref.cpu().numpy().astype(np.float64)), gen


@pytest.mark.cuda
@pytest.mark.parametrize("p,sizes", [(5, (2, 64, 64, 1)),
                                     (64, (2, 250, 250, 1))])
def test_nnf_pop_kernel_matches_plain_on_card(card, p, sizes):
    """The trip kernel at Q = 1: the ring pass at one row; 250 does not
    divide its chunk depth."""
    nets = _net(seed=p, members=p, sizes=sizes, device=card)
    v = TP.activation_protocol(20.0, 1.0, device=card).v
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    kw = dict(proto_dt=1.0, trips=2048)
    before = TK.fused_nnf_pop_solve_ft.launches
    ys_k = TK.fused_nnf_pop_solve_ft(nets, TR.HH_B06, v, ts, **kw)
    torch.cuda.synchronize()
    assert TK.fused_nnf_pop_solve_ft.launches == before + 1
    ys_p = TK.fused_nnf_pop_solve_ft_plain(nets, TR.HH_B06, v, ts, **kw)
    assert TK.fused_nnf_pop_solve_ft.launches == before + 1
    assert tuple(ys_k.shape) == (p, 80, 2)
    assert bool(torch.isfinite(ys_k).all())
    _close_on_card(ys_k, ys_p)


@pytest.mark.cuda
def test_while_kernel_matches_plain_on_card(card):
    """The while-loop sweep: kernel vs plain on a healthy family, and a
    lane whose rates overflow (+5000 mV from 1000 ms) ending the whole
    launch as inf in both within a small max_steps."""
    net = _net(sizes=(2, 64, 64, 64, 1), device=card)
    v = _protos((-40.0, 0.0, 20.0), device=card)
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    before = TK.fused_nnf_solve.launches
    ys_k = TK.fused_nnf_solve(net, TR.HH_B06, v, ts, proto_dt=1.0)
    torch.cuda.synchronize()
    assert TK.fused_nnf_solve.launches == before + 1
    ys_p = TK.fused_nnf_solve_plain(net, TR.HH_B06, v, ts, proto_dt=1.0)
    assert TK.fused_nnf_solve.launches == before + 1
    assert bool(torch.isfinite(ys_p).all())
    _close_on_card(ys_k, ys_p)
    v[-1, 1000:] = 5000.0
    kw = dict(proto_dt=1.0, t_end=2000.0, max_steps=300)
    ts = torch.linspace(0.0, 2000.0, 41, device=card)
    ys_k = TK.fused_nnf_solve(net, TR.HH_B06, v, ts, **kw)
    ys_p = TK.fused_nnf_solve_plain(net, TR.HH_B06, v, ts, **kw)
    assert bool(torch.isinf(ys_k).all()) and bool(torch.isinf(ys_p).all())


@pytest.mark.cuda
def test_bias_probe_kernel_matches_plain_on_card(card):
    w, b = _probe_script().probe_inputs(card)
    for fold in (False, True):
        before = TB.bias_probe.launches
        out_k = TB.bias_probe(w, b, fold=fold)
        torch.cuda.synchronize()
        assert TB.bias_probe.launches == before + 1
        out_p = TB.bias_probe_plain(w, b, fold=fold)
        assert tuple(out_k.shape) == (64, 128)
        assert float((out_k - out_p).abs().max()) <= 1e-5


# The population launches' layer pass (the ring of weight chunks; mma.sync in
# bf16): shapes across the row tiles RT = 1, 8, 16, 32, grids of 1 to 128
# blocks and widths whose k-depth does not divide the chunk.


def _levels(q):
    return tuple(float(x) for x in np.linspace(-60.0, 40.0, q))


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,sizes,mode", [
    (1, 1, (2, 64, 64, 1), "f32"),
    (5, 3, (2, 64, 64, 1), "f32"),
    (5, 9, (2, 64, 64, 1), "f32"),
    (128, 32, (2, 64, 64, 1), "f32"),
    (128, 9, (2, 16, 16, 1), "f32"),
    (5, 3, (2, 250, 250, 1), "f32"),
    (5, 32, (2, 37, 130, 1), "f32"),
    (4, 7, (2, 64, 64, 1), "nnd"),
    (5, 4, (2, 64, 64, 1), "bf16"),
    (5, 9, (2, 250, 250, 1), "bf16"),
    (128, 32, (2, 64, 64, 1), "bf16"),
])
def test_popsweep_ring_pass_matches_plain_on_card(card, p, q, sizes, mode):
    """The popsweep kernel against its plain version across P, Q, widths
    (250 does not divide its chunk depth in either mode), NN-d and bf16;
    lane (0, q - 1) starts dead and stays inf (where it is not the only
    lane)."""
    nets = _net(seed=p + q, members=p, sizes=sizes, device=card)
    v = _protos(_levels(q), device=card)
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    y0 = torch.zeros(p, q, 2, device=card)
    y0[..., 1] = 1.0
    if p * q > 1:
        y0[0, q - 1] = float("nan")
    kw = dict(proto_dt=1.0, trips=2048, y0=y0, mxu_bf16=mode == "bf16",
              base_hh=TR.HH_B06 if mode == "nnd" else None)
    before = TK.fused_nnf_popsweep_solve_ft.launches
    ys_k = TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, v, ts, **kw)
    torch.cuda.synchronize()
    assert TK.fused_nnf_popsweep_solve_ft.launches == before + 1
    ys_p = TK.fused_nnf_popsweep_solve_ft_plain(nets, TR.HH_B06, v, ts, **kw)
    assert tuple(ys_k.shape) == (p, q, ts.shape[0], 2)
    assert bool(torch.isinf(ys_k[0, q - 1]).all()) == (p * q > 1)
    assert bool(torch.isfinite(ys_p[0, :q - 1]).all())
    _close_on_card(ys_k, ys_p)


@pytest.mark.cuda
@pytest.mark.parametrize("q,mode", [(16, "f32"), (32, "f32"), (32, "bf16")])
def test_popsweep_ring_pass_q_split_is_bit_identical_on_card(card, q, mode):
    """q_split = 2 halves the row tile (RT 16 -> 8, 32 -> 16): every row's
    sums run in the same order, so the records are bit-identical."""
    nets = _net(seed=3, members=3, sizes=(2, 250, 250, 1), device=card)
    v = _protos(_levels(q), device=card)
    kw = dict(proto_dt=1.0, trips=2048, return_records=True,
              mxu_bf16=mode == "bf16")
    ts = torch.tensor([0.0, 8000.0], device=card)
    r1 = TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, v, ts, **kw)
    r2 = TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, v, ts, q_split=2,
                                        **kw)
    n = int(r1.n_valid)
    assert n == int(r2.n_valid) and int(r1.n_acc) == int(r2.n_acc) > 0
    for a, b in ((r1.rec_sc, r2.rec_sc), (r1.rec_y, r2.rec_y),
                 (r1.rec_k, r2.rec_k)):
        assert torch.equal(a[:n], b[:n])
    assert torch.equal(r1.mask, r2.mask)


@pytest.mark.cuda
@pytest.mark.parametrize("q,mode", [(9, "f32"), (5, "f32"), (17, "f32"),
                                    (9, "bf16"), (17, "bf16")])
def test_ring_pass_copies_padded_rows_bit_for_bit_on_card(card, q, mode):
    """The popsweep pads Q to a power of two with copies of the last row;
    the ring pass computes only the real rows (q_real) and hands a padded
    row its copy's MLP output.  The records equal those of a launch that
    computes every row, bit for bit."""
    import dataclasses

    nets = _net(seed=q, members=3, sizes=(2, 250, 250, 1), device=card)
    v = _protos(_levels(q), device=card)
    ts = torch.tensor([0.0, 8000.0], device=card)
    s = TK._popsweep_setup(nets, TR.HH_B06, v, ts, 0.0, 1.0, None, 1e-5,
                           1e-7, 2048, None, None, True, mode == "bf16", 1)
    assert s.q_real == q and s.y0.shape[1] > q
    real = TK._trip_solve_cuda(s)
    every = TK._trip_solve_cuda(dataclasses.replace(s, q_real=0))
    n = int(real[3][1])
    assert torch.equal(real[3], every[3]) and int(real[3][0]) > 0
    for a, b in zip(real[:3], every[:3]):
        assert torch.equal(a[:n], b[:n])
    assert torch.equal(real[4], every[4])


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["popsweep", "bf16", "population"])
def test_ring_pass_takes_500_wide_members_on_card(card, entry):
    """The registry's 500-wide architecture (s07: Linear(2, 500), Linear(500,
    500), Linear(500, 1)) as a 4-member population: more columns than one
    pass of the ring's threads covers, so each chunk takes two passes with
    the running sums parked in shared memory (one at one row per block).
    Kernel against plain within 5e-3 on the gates, in f32 and bf16 and
    through the population solve.  In bf16 a 1,000-wide net, past the ring
    pass's widest layer, takes the mlp() pass (launch_plan's second
    branch) at 16-row tiles, within 5e-3 of plain too."""
    nets = [(w * (16 / 500) ** 0.5, b) for w, b in _net(
        seed=5, members=4, sizes=(2, 500, 500, 1), device=card)]
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    kw = dict(proto_dt=1.0, trips=2048)
    if entry == "population":
        v = TP.activation_protocol(20.0, 1.0, device=card).v
        ys_k = TK.fused_nnf_pop_solve_ft(nets, TR.HH_B06, v, ts, **kw)
        torch.cuda.synchronize()
        assert TK._trip_solve_cuda.last_pass == dict(
            layer_pass="ring", row_tile=1, column_passes=1)
        ys_p = TK.fused_nnf_pop_solve_ft_plain(nets, TR.HH_B06, v, ts, **kw)
    else:
        v = _protos(_levels(9), device=card)
        kw["mxu_bf16"] = entry == "bf16"
        ys_k = TK.fused_nnf_popsweep_solve_ft(nets, TR.HH_B06, v, ts, **kw)
        torch.cuda.synchronize()
        assert TK._trip_solve_cuda.last_pass == dict(
            layer_pass="ring", row_tile=16, column_passes=2)
        ys_p = TK.fused_nnf_popsweep_solve_ft_plain(nets, TR.HH_B06, v, ts,
                                                    **kw)
    assert bool(torch.isfinite(ys_p).all())
    _close_on_card(ys_k, ys_p)
    if entry == "bf16":
        wide = [(w * (16 / 1000) ** 0.5, b) for w, b in _net(
            seed=5, members=4, sizes=(2, 1000, 1000, 1), device=card)]
        before = TK.fused_nnf_popsweep_solve_ft.launches
        ys_k = TK.fused_nnf_popsweep_solve_ft(wide, TR.HH_B06, v, ts, **kw)
        torch.cuda.synchronize()
        assert TK.fused_nnf_popsweep_solve_ft.launches == before + 1
        assert TK._trip_solve_cuda.last_pass == dict(layer_pass="mlp",
                                                     row_tile=16)
        ys_p = TK.fused_nnf_popsweep_solve_ft_plain(wide, TR.HH_B06, v, ts,
                                                    **kw)
        assert bool(torch.isfinite(ys_p).all())
        _close_on_card(ys_k, ys_p)


def _wide_members(card, p, width):
    """p members of a (2, width, width, 1) net made on the card from a
    seeded generator: weights 0.1 sqrt(16 / fan-in) N(0, 1), biases 0.01
    N(0, 1) (activations stay O(1) through the wide layer)."""
    gen = torch.Generator(device=card).manual_seed(width)
    sizes = (2, width, width, 1)
    return [(torch.randn(p, a, b, generator=gen, device=card)
             * (0.1 * (16 / max(a, 16)) ** 0.5),
             0.01 * torch.randn(p, b, generator=gen, device=card))
            for a, b in zip(sizes[:-1], sizes[1:])]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,width,row_tile", [
    ("popsweep", 11_520, 1), ("bf16", 960, 16), ("population", 11_520, 1)])
def test_population_launches_take_mlp_past_the_ring_on_card(card, entry,
                                                            width, row_tile):
    """Layers just past the ring pass's widest (11,512 in f32, 952 in bf16):
    launch_plan sends the launch through mlp() at the largest row tile
    whose activation buffers fit, names it in last_pass, and the kernel is
    within 5e-3 of plain on the gates.  A short protocol at 1 ms knots
    (50 ms at -80 mV, 100 ms at +20, back to -80 until 200 ms): mlp() reads
    each f32 member's 531 MB of weights from HBM six times a trip."""
    v = torch.full((201,), -80.0, device=card)
    v[50:150] = 20.0
    ts = torch.arange(5.0, 200.0, 10.0, device=card)
    kw = dict(proto_dt=1.0, trips=1024)
    if entry == "population":
        nets = _wide_members(card, 2, width)
        kern, plain = TK.fused_nnf_pop_solve_ft, TK.fused_nnf_pop_solve_ft_plain
    else:
        nets = _wide_members(card, 4 if entry == "bf16" else 2, width)
        levels = (-60.0, -20.0, 0.0, 20.0, 40.0) if entry == "bf16" else (
            -20.0, 40.0)
        v = torch.stack([torch.where(v > 0, x, v) for x in levels] + (
            [v] * 4 if entry == "bf16" else []))        # 9 rows in bf16
        kw["mxu_bf16"] = entry == "bf16"
        kern = TK.fused_nnf_popsweep_solve_ft
        plain = TK.fused_nnf_popsweep_solve_ft_plain
    before = kern.launches
    ys_k = kern(nets, TR.HH_B06, v, ts, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert TK._trip_solve_cuda.last_pass == dict(layer_pass="mlp",
                                                 row_tile=row_tile)
    ys_p = plain(nets, TR.HH_B06, v, ts, **kw)
    assert bool(torch.isfinite(ys_p).all())
    _close_on_card(ys_k, ys_p)


def _standin_population(card, members=4):
    """``members`` nets of 2 x 64 x 64 x 1 and test_pallas.py's stand-in
    recordings (6,001 and 3,501 samples at 1 ms) with noisy targets."""
    from ionflux_torch import eval as TE

    layers = _net(seed=3, members=members, sizes=(2, 64, 64, 1), device=card)
    pop = TN.NNfParams(TN.MLP(layers), TR.HH_B06)
    volts = {n: (TP.activation_protocol(x, 1.0, device="cpu").v[:ln].numpy(),
                 1.0) for n, x, ln in (("a", 20.0, 6001), ("b", -30.0, 3501))}
    kw = dict(trips=1024, seg_samples=2048, chunk=512, voltages=volts)
    cur = TE.simulate_population_real("nnf", pop, ["a", "b"], TR.SYNTHETIC,
                                      **kw)
    rs = np.random.RandomState(0)
    truth = {n: cur[n][0] + 0.01 * rs.randn(cur[n].shape[1]) for n in cur}
    return TE, pop, truth, cur, kw


@pytest.mark.cuda
def test_population_real_kernel_matches_plain_on_card(card):
    """simulate_population_real through the chained popsweep kernel against
    the plain chain on the CPU: the currents within 5e-3 x 126 mV."""
    TE, pop, _, cur, kw = _standin_population(card)
    cpu = TN.NNfParams(TN.MLP([(w.cpu(), b.cpu()) for w, b in
                               pop.net.layers]), TR.HH_B06)
    ref = TE.simulate_population_real("nnf", cpu, ["a", "b"], TR.SYNTHETIC,
                                      **kw)
    for n in cur:
        assert np.isfinite(cur[n]).all()
        assert float(np.abs(cur[n] - ref[n]).max()) <= CARD_TOL * 126


@pytest.mark.cuda
def test_rollout_maes_graph_replays_the_eager_chain_on_card(card):
    """population_rollout_maes on the card: the first call runs the chain
    eagerly (one popsweep launch per segment) and captures it as one CUDA
    graph; each later call copies its weights and targets in and replays
    it, bit for bit equal to the eager chain (graph=False), for the first
    weights and for new ones; each replay counts its segments' launches."""
    TE, pop, truth, _, kw = _standin_population(card)
    names = ["a", "b"]
    k = TK.fused_nnf_popsweep_solve_ft
    TE._ROLLOUT_GRAPHS.clear()
    before = k.launches
    first = TE.population_rollout_maes("nnf", pop, names, TR.SYNTHETIC, truth,
                                       spans={"b": (500, 3000)}, **kw)
    assert k.launches == before + 3 and len(TE._ROLLOUT_GRAPHS) == 1
    replay = TE.population_rollout_maes("nnf", pop, names, TR.SYNTHETIC,
                                        truth, spans={"b": (500, 3000)}, **kw)
    assert k.launches == before + 6
    eager = TE.population_rollout_maes("nnf", pop, names, TR.SYNTHETIC, truth,
                                       spans={"b": (500, 3000)}, graph=False,
                                       **kw)
    assert np.isfinite(first).all()
    assert np.array_equal(first, replay) and np.array_equal(eager, replay)
    other = TN.NNfParams(TN.MLP([(w * 1.01, b) for w, b in pop.net.layers]),
                         TR.HH_B06)
    got = [TE.population_rollout_maes("nnf", other, names, TR.SYNTHETIC,
                                      truth, graph=g, **kw)
           for g in (True, False)]
    assert len(TE._ROLLOUT_GRAPHS) == 1 and not np.array_equal(got[0], first)
    assert np.array_equal(got[0], got[1])


# The sweeps' layer passes (B2, B6): the cluster pass (weights in a
# cluster's shared memory, DSMEM exchange) against mlp() on the same inputs,
# bit for bit, across one to four clusters; and mlp() where the size rule
# keeps it.

D1_SIZES = (2, 200, 200, 200, 200, 200, 200, 1)


def _tame(net, gain=0.5):
    """A random net with its weights scaled by ``gain``: at widths of 200
    and more, _net's 0.1 N(0, 1) weights grow each layer's activations
    (0.1 sqrt(200) > 1) into nets whose solves are stiff or chaotic."""
    return [(w * gain, b) for w, b in net]


def _sweep_case(card, b, sizes, base, die):
    """A sweep setup of b rows on a random net; with ``die``, the last row's
    voltage is NaN, so its first stage is and it dies alone at the start
    (a lane that fails only later is held back by the f32 clock: near a
    bad knot its steps shrink until t + h rounds to t, and they pass)."""
    net = _tame(_net(seed=b, sizes=sizes, device=card))
    v = _protos(_levels(b), device=card)
    if die:
        v[-1] = float("nan")
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    kw = dict(proto_dt=1.0, trips=2048, base_hh=TR.HH_B06 if base else None)
    s = TK._sweep_setup(net, TR.HH_B06, v, ts, 0.0, 1.0, None, 1e-5, 1e-7,
                        2048, kw["base_hh"])
    return net, v, ts, kw, s


def _same_records(out_a, out_b, n):
    """The first n records of two launches, bit for bit (a dead lane's
    records hold NaN, which torch.equal never finds equal)."""
    for a, b in zip(out_a[:3], out_b[:3]):
        assert torch.equal(a[:n].view(torch.int32), b[:n].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [D1_SIZES, (2, 37, 130, 64, 1)],
                         ids=["d1", "2x37x130x64x1"])
@pytest.mark.parametrize("base", [None, "nnd"])
@pytest.mark.parametrize("b", [1, 7, 32, 33, 128])
def test_sweep_cluster_pass_equals_mlp_on_card(card, b, base, sizes):
    """B2 through the cluster pass (the size rule's choice) and through
    mlp() gives bit-identical records, n_out and alive at one to four
    clusters, in NN-f and NN-d, with one lane that dies alone; the entry
    point's result is within CARD_TOL of the plain version.  The second net
    makes an odd number of exchanges per evaluation (uneven slices too)."""
    import dataclasses

    net, v, ts, kw, s = _sweep_case(card, b, sizes, base, die=b > 1)
    clus = TK._trip_solve_cuda(s)
    assert TK._trip_solve_cuda.last_pass == dict(
        layer_pass="cluster", cluster_size=TK.CLUSTER_SIZE,
        clusters=-(-b // 32))
    glob = TK._trip_solve_cuda(dataclasses.replace(s, cluster=0))
    assert TK._trip_solve_cuda.last_pass["layer_pass"] == "mlp"
    n = int(clus[3][1])
    assert torch.equal(clus[3], glob[3]) and int(clus[3][0]) > 0
    _same_records(clus, glob, n)
    assert torch.equal(clus[4], glob[4])
    assert bool(clus[4][0, :-1].all()) and bool(clus[4][0, -1]) == (b == 1)
    before = TK.fused_nnf_solve_ft.launches
    ys_k = TK.fused_nnf_solve_ft(net, TR.HH_B06, v, ts, **kw)
    torch.cuda.synchronize()
    assert TK.fused_nnf_solve_ft.launches == before + 1
    assert TK.fused_nnf_solve_ft.last_pass["layer_pass"] == "cluster"
    ys_p = TK.fused_nnf_solve_ft_plain(net, TR.HH_B06, v, ts, **kw)
    _close_on_card(ys_k, ys_p)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [7, 40])
def test_while_cluster_pass_equals_mlp_on_card(card, b):
    """B6 through the cluster pass and through mlp(): bit-identical records
    and n_out, on one and on two clusters; within CARD_TOL of plain."""
    import dataclasses

    net = _tame(_net(seed=b, sizes=D1_SIZES, device=card))
    v = _protos(_levels(b), device=card)
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    s = TK._sweep_setup(net, TR.HH_B06, v, ts, 0.0, 1.0, None, 1e-5, 1e-7,
                        4096, None, block=1)
    clus = TK._while_solve_cuda(s, 100_000)
    assert TK._while_solve_cuda.last_pass == dict(
        layer_pass="cluster", cluster_size=TK.CLUSTER_SIZE,
        clusters=-(-b // 32))
    glob = TK._while_solve_cuda(dataclasses.replace(s, cluster=0), 100_000)
    assert torch.equal(clus[3], glob[3]) and int(clus[3][0]) > 0
    _same_records(clus, glob, int(clus[3][0]))
    ys_k = TK.fused_nnf_solve(net, TR.HH_B06, v, ts, proto_dt=1.0)
    assert TK.fused_nnf_solve.last_pass["layer_pass"] == "cluster"
    ys_p = TK.fused_nnf_solve_plain(net, TR.HH_B06, v, ts, proto_dt=1.0)
    assert bool(torch.isfinite(ys_p).all())
    _close_on_card(ys_k, ys_p)


@pytest.mark.cuda
def test_sweep_keeps_mlp_for_a_net_too_large_for_a_cluster_on_card(card):
    """A 5 x 512 net (5.2 MB) takes mlp() by the size rule, in B2 and in
    B6, and matches the plain version; the cluster pass at C = 16 (the
    non-portable size) gives the same records as at C = 8 on d1."""
    import dataclasses

    net = _tame(_net(seed=5, sizes=(2, 512, 512, 512, 512, 512, 1),
                     device=card), 0.25)
    v = _protos((-40.0, 20.0), device=card)
    ts = torch.arange(50.0, 8000.0, 100.0, device=card)
    ys_k = TK.fused_nnf_solve_ft(net, TR.HH_B06, v, ts, proto_dt=1.0,
                                 trips=2048)
    assert TK.fused_nnf_solve_ft.last_pass == dict(
        layer_pass="mlp", cluster_size=0, clusters=0)
    _close_on_card(ys_k, TK.fused_nnf_solve_ft_plain(
        net, TR.HH_B06, v, ts, proto_dt=1.0, trips=2048))
    ys_k = TK.fused_nnf_solve(net, TR.HH_B06, v, ts, proto_dt=1.0)
    assert TK.fused_nnf_solve.last_pass["layer_pass"] == "mlp"
    _close_on_card(ys_k, TK.fused_nnf_solve_plain(net, TR.HH_B06, v, ts,
                                                  proto_dt=1.0))
    *_, s = _sweep_case(card, 33, D1_SIZES, None, die=True)
    c8 = TK._trip_solve_cuda(dataclasses.replace(s, cluster=8))
    c16 = TK._trip_solve_cuda(dataclasses.replace(s, cluster=16))
    assert TK._trip_solve_cuda.last_pass["cluster_size"] == 16
    assert torch.equal(c8[3], c16[3]) and torch.equal(c8[4], c16[4])
    _same_records(c8, c16, int(c8[3][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hh", "markov", "nnf", "nnd", "gta",
                                  "rgate"])
def test_odeint_graph_replay_equals_stepwise_on_card(card, kind):
    """The blocked odeint on the card (its first block eager, then the
    captured block's graph replayed; a second solve of the same setting
    replays only) equals the per-step loop bit for bit, on every right-hand
    side of the port's paths: the five model kinds and the r-gate."""
    from ionflux_torch.eval import _model_rhs, default_y0
    from ionflux_torch.solver import dopri5 as TD
    from ionflux_torch.surface import _rhs_r

    proto = TP.activation_protocol(20.0, 1.0, device=card)
    ts = torch.linspace(0.0, 8000.0, 801, device=card)
    net = TN.MLP(_net(3, device=card))
    params = {"hh": TR.HH_B06, "markov": TR.MARKOV_B06, "gta": TR.MARKOV_B06,
              "nnf": TN.NNfParams(net, TR.HH_B06),
              "nnd": TN.NNdParams(net, TR.HH_D2_BASE),
              "rgate": TR.HH_B06}[kind]
    args = (params, proto)
    if kind == "rgate":
        fn, y0 = _rhs_r, torch.ones(1, device=card)
    else:
        fn, y0 = _model_rhs(kind), default_y0(kind, device=card)
    want = TD._odeint_stepwise(fn, y0, ts, args, return_stats=True)
    for _ in range(2):
        got = TD.odeint(fn, y0, ts, args, return_stats=True)
        assert got[1] == want[1] and got[1].ok
        assert torch.equal(got[0], want[0])
    assert any(k[0] == TD._fn_key(fn) for k in TD._GRAPHS)


def _surface_case(device, n=256, seed=0):
    rs = np.random.RandomState(seed)
    x = np.stack([rs.uniform(-1.2, 0.4, n), rs.uniform(0.02, 0.98, n)], -1)
    y = 1e-3 * np.tanh(3 * x[:, 0]) * (1 - x[:, 1])
    return [torch.as_tensor(z, dtype=torch.float32, device=device)
            for z in (x, y, 1e-4 * x[:, 1])]


@pytest.mark.cuda
def test_fit_chunk_graph_on_card(card):
    """fit_chunk on the card (three eager updates, then the captured update
    replayed) against the CPU's eager chunk: the loss traces within 1e-3
    relative (GPU vs CPU sums, capturable Adam's rate on the device); and
    on the card 17 + 17 + 16 updates resumed across chunks equal one chunk
    of 50 bit for bit."""
    from ionflux_torch.fit import train as TT

    net = _net(7)
    kw = dict(lr=1e-2, step_size=10, gamma=0.5)
    x, y, r = _surface_case("cpu")
    _, _, l_cpu = TT.fit_chunk(net, TT.init_opt_state(net), x, y, r,
                               iters=50, **kw)
    net_c = [(w.to(card), b.to(card)) for w, b in net]
    xc, yc, rc = _surface_case(card)
    one, s1, l_one = TT.fit_chunk(net_c, TT.init_opt_state(net_c), xc, yc,
                                  rc, iters=50, **kw)
    np.testing.assert_allclose(l_one.cpu().numpy(), l_cpu.numpy(),
                               rtol=1e-3)
    cur, state, parts = net_c, TT.init_opt_state(net_c), []
    for n in (17, 17, 16):
        cur, state, losses = TT.fit_chunk(cur, state, xc, yc, rc, iters=n,
                                          **kw)
        parts.append(losses)
    assert state.count == s1.count == 50
    assert torch.equal(torch.cat(parts), l_one)
    for (a, b), (c, d) in zip(cur.layers, one.layers):
        assert torch.equal(a, c) and torch.equal(b, d)


@pytest.mark.cuda
def test_tridiag_kernel_matches_plain_on_card(card):
    """K1 (one thread per system) against its plain loop on the CPU, on a
    batch of systems of 1, 2, 40 and 5,000 rows: bit for bit (every product,
    sum and quotient rounded on its own in both); one launch counted."""
    from ionflux_torch.ops import spline as TS

    rs = np.random.RandomState(0)
    lengths = [40, 1, 5000, 2]
    n = sum(lengths)
    dl, d, du, b = (torch.from_numpy(x.astype(np.float32)) for x in (
        rs.uniform(0.5, 1.0, n), rs.uniform(3.0, 4.0, n),
        rs.uniform(0.5, 1.0, n), rs.randn(n)))
    want = TS.tridiag_solve_batched(dl, d, du, b, lengths)
    before = TS.tridiag_solve_batched.launches
    got = TS.tridiag_solve_batched(*(x.to(card) for x in (dl, d, du, b)),
                                   lengths)
    torch.cuda.synchronize()
    assert TS.tridiag_solve_batched.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n, m", [(4, 1000), (1, 3), (16, 20)])
def test_sym_eig_kernel_matches_plain_on_card(card, n, m):
    """K2 (one warp per matrix) against its plain version on the same card,
    bit for bit, and against torch.linalg.eigh: eigenvalues and
    B diag(d) B^T within 1e-5 of the matrix's scale."""
    from ionflux_torch.ops import sym_eig as TS

    rs = np.random.RandomState(n)
    q = rs.randn(m, n, n)
    a = torch.from_numpy((q @ q.transpose(0, 2, 1)
                          + 0.1 * np.eye(n)).astype(np.float32))
    w_p, v_p = TS.sym_eig_plain(a.to(card))
    before = TS.sym_eig.launches
    w_k, v_k = TS.sym_eig(a.to(card))
    torch.cuda.synchronize()
    assert TS.sym_eig.launches == before + 1
    assert torch.equal(w_k, w_p) and torch.equal(v_k, v_p)
    scale = a.abs().amax(dim=(-2, -1), keepdim=True)
    w_ref = torch.linalg.eigh(a.double())[0].float()
    assert torch.all((w_k.cpu() - w_ref).abs() <= 1e-5 * scale[..., 0])
    rec = (v_k @ torch.diag_embed(w_k) @ v_k.transpose(-2, -1)).cpu()
    assert torch.all((rec - a).abs() <= 1e-5 * scale)


@pytest.mark.cuda
def test_odeint_batched_graph_replay_equals_stepwise_on_card(card):
    """The blocked lockstep solve on the card (its first block eager, then
    the captured block replayed; a second solve replays only) equals the
    per-step loop bit for bit, with a lane dead from the start."""
    from ionflux_torch.solver import batched as TBa

    base = np.array([float(x) for x in TR.HH_B06], np.float32)
    ps = torch.from_numpy(base[None] * np.exp(
        0.1 * np.random.RandomState(0).randn(3, 8)).astype(np.float32))
    proto = TP.activation_protocol(20.0, 1.0, device=card)
    ts = torch.linspace(0.0, 8000.0, 801, device=card)
    y0 = torch.tensor([[0.0, 1.0], [float("nan"), 1.0], [0.0, 1.0]],
                      device=card)
    args = (ps.to(card), proto)
    kw = dict(rtol=1e-5, atol=1e-7, return_stats=True)
    fn = _rhs_hh_pop
    want = TBa._odeint_batched_stepwise(fn, y0, ts, args, **kw)
    for _ in range(2):
        got = TBa.odeint_batched(fn, y0, ts, args, **kw)
        assert (got[1].n_accepted, got[1].n_steps) == (
            want[1].n_accepted, want[1].n_steps)
        assert torch.equal(got[1].ok, want[1].ok)
        assert torch.equal(got[0], want[0])
    assert got[1].ok.tolist() == [True, False, True]


def _rhs_hh_pop(t, y, args):
    ps, proto = args
    v = TP.voltage(proto, t)
    k1 = ps[:, 0] * torch.exp(ps[:, 1] * v)
    k2 = ps[:, 2] * torch.exp(-ps[:, 3] * v)
    k3 = ps[:, 4] * torch.exp(ps[:, 5] * v)
    k4 = ps[:, 6] * torch.exp(-ps[:, 7] * v)
    return torch.stack([k1 * (1.0 - y[:, 0]) - k2 * y[:, 0],
                        -k3 * y[:, 1] + k4 * (1.0 - y[:, 1])], dim=-1)


@pytest.mark.cuda
def test_cmaes_onchip_replays_its_chunks_on_card(card):
    """cmaes_onchip on the card: one chunk of 8 generations captured (K2,
    the draw and the objective inside) and replayed with one host read a
    chunk; it converges as tests/test_fit.py's log-space case does, K2's
    launches are counted through the replays, and the count is exact."""
    from ionflux_torch.fit.cmaes import cmaes_onchip
    from ionflux_torch.ops import sym_eig as TS

    opt = np.array([3e-4, 5e-2, 1e-5, 7e-2])
    log_opt = torch.log(torch.tensor(opt, dtype=torch.float32, device=card))

    def batch(xs):
        return torch.sum((torch.log(xs) - log_opt) ** 2, dim=1)

    before = TS.sym_eig.launches
    res = cmaes_onchip(batch, opt * 3.0, 0.1 * opt * 3.0,
                       bounds=(opt * 0.01, opt * 100.0), seed=1,
                       device=card)
    np.testing.assert_allclose(res.x, opt, rtol=1e-3)
    assert res.iterations < 2000 and res.evaluations == res.iterations * 8
    chunks = len(res.history) - 1
    # one eager warm-up generation, then every replayed chunk (the
    # lookahead one included) launches K2 once a generation
    assert TS.sym_eig.launches - before == 1 + 8 * (chunks + 1)
    cut = cmaes_onchip(batch, opt * 3.0, 0.1 * opt * 3.0,
                       bounds=(opt * 0.01, opt * 100.0), seed=1,
                       max_iterations=13, device=card)
    assert cut.iterations == 13 and cut.hit_max_iterations
    assert [h[0] for h in cut.history] == [0, 8, 13]


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["adams", "vcabm", "rosenbrock"])
@pytest.mark.parametrize("kind", ["hh", "markov", "nnf"])
def test_method_graph_replay_equals_stepwise_on_card(card, method, kind):
    """Each adaptive method's blocked loop on the card (first block eager,
    then its captured block replayed; a second solve replays only) equals
    its per-step loop bit for bit, and every block ran as a graph of its
    own key."""
    from ionflux_torch.eval import _model_rhs, default_y0
    from ionflux_torch.solver import adams, dopri5, implicit, vcabm

    solve, stepwise = {
        "adams": (adams.odeint_adams, adams._adams_stepwise),
        "vcabm": (vcabm.odeint_vcabm, vcabm._vcabm_stepwise),
        "rosenbrock": (implicit.odeint_rosenbrock,
                       implicit._rosenbrock_stepwise)}[method]
    proto = TP.activation_protocol(20.0, 1.0, device=card)
    ts = torch.linspace(0.0, 8000.0, 801, device=card)
    params = {"hh": TR.HH_B06, "markov": TR.MARKOV_B06,
              "nnf": TN.NNfParams(TN.MLP(_net(3, device=card)),
                                  TR.HH_B06)}[kind]
    fn, y0 = _model_rhs(kind), default_y0(kind, device=card)
    kw = dict(rtol=1e-5, atol=1e-7, return_stats=True)
    want = stepwise(fn, y0, ts, (params, proto), **kw)
    for _ in range(2):
        got = solve(fn, y0, ts, (params, proto), **kw)
        assert got[1] == want[1] and got[1].ok
        assert torch.equal(got[0], want[0])
    assert any(k[0] == dopri5._fn_key(fn) and k[3][0] == method
               for k in dopri5._GRAPHS)


@pytest.mark.cuda
def test_adjoint_backward_captures_once_across_intervals_on_card(card):
    """The adjoint's backward on the card: the fixed-step branch (a net
    past RK4_ABOVE parameters) captures its interval once and replays it
    for every later interval; a second backward replays only and gives
    the same gradients bit for bit; both against the CPU's within the
    adjoint tests' bound.  The adaptive branch (HH parameters) runs its
    backward solves on one captured block."""
    from ionflux_torch.models import nnf_rhs
    from ionflux_torch.solver import adjoint as TAD
    from ionflux_torch.solver import dopri5

    def rhs(t, y, args):
        return nnf_rhs(TN.NNfParams(args[0], TR.HH_B06), t, y,
                       TP.voltage(args[1], t))

    def grads(device):
        net = [(w.requires_grad_(True), b.requires_grad_(True))
               for w, b in _net(4, sizes=(2, 100, 100, 1), device=device)]
        proto = TP.activation_protocol(20.0, 1.0, device=device)
        ts = torch.linspace(0.0, 500.0, 11, device=device)
        ys = TAD.odeint_adjoint(rhs, torch.tensor([0.1, 0.9], device=device),
                                ts, (net, proto), 1e-6, 1e-8)
        torch.mean(ys[:, 0] ** 2).backward()
        return [x.grad.cpu() for pair in net for x in pair]

    n0 = len(TAD._INTERVAL_GRAPHS)
    first = grads(card)
    assert len(TAD._INTERVAL_GRAPHS) == n0 + 1
    second = grads(card)
    assert len(TAD._INTERVAL_GRAPHS) == n0 + 1
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    ref = grads("cpu")
    a = torch.cat([g.reshape(-1) for g in first]).double()
    b = torch.cat([g.reshape(-1) for g in ref]).double()
    assert float((a - b).norm() / b.norm()) < 1e-3

    def hh_grad(device):
        p = torch.tensor([float(x) for x in TR.HH_B06], device=device,
                         requires_grad=True)

        def f(t, y, args):
            q, pr = args
            v = TP.voltage(pr, t)
            k1, k2 = q[0] * torch.exp(q[1] * v), q[2] * torch.exp(-q[3] * v)
            k3, k4 = q[4] * torch.exp(q[5] * v), q[6] * torch.exp(-q[7] * v)
            return torch.stack([k1 * (1 - y[0]) - k2 * y[0],
                                -k3 * y[1] + k4 * (1 - y[1])])

        proto = TP.activation_protocol(0.0, 1.0, device=device)
        ts = torch.linspace(0.0, 2000.0, 21, device=device)
        ys = TAD.odeint_adjoint(f, torch.tensor([0.0, 1.0], device=device),
                                ts, (p, proto), 1e-8, 1e-10)
        torch.mean(ys[:, 0] ** 2).backward()
        return p.grad.cpu().double()

    g_card = hh_grad(card)
    assert sum(k[0] == dopri5._fn_key(TAD._aug_rhs)
               for k in dopri5._GRAPHS) >= 1
    g_cpu = hh_grad("cpu")
    assert float((g_card - g_cpu).norm() / g_cpu.norm()) < 1e-3


@pytest.mark.cuda
def test_neural_ode_step_graph_replays_the_eager_step_on_card(card,
                                                              monkeypatch):
    """The neural-ODE script's RK4-mode updates on the card through the
    graph path (the fused kernels' size rule forced to refuse the net):
    with the interval's two captured graphs replayed, three updates give
    the eager updates' losses and net bit for bit."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import train_neural_ode_torch as T

    from ionflux_torch.ops import node_rk4 as NR

    monkeypatch.setattr(NR, "node_cluster", lambda sizes, n_sub: 0)
    proto = TP.activation_protocol(20.0, 1.0, device=card)
    ts = torch.linspace(0.0, 300.0, 31, device=card)
    data = torch.linspace(0.0, 1.0, 31, device=card)
    runs = {}
    for graph in (False, True):
        tr = T.Trainer(_net(6, sizes=(2, 16, 16, 1), device=card), proto,
                       ts, torch.tensor([0.0, 1.0], device=card), data,
                       adjoint=False, graph=graph)
        runs[graph] = ([tr.step() for _ in range(3)], tr)
    assert runs[True][1].graphs is not None and runs[False][1].graphs is None
    assert not runs[True][1].fused
    for a, b in zip(runs[False][0], runs[True][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs[False][1].flat, runs[True][1].flat):
        assert torch.equal(a, b)
