"""The port's parallel path over several processes on the CPU: ranks
started by ``parallel.run_processes`` (spawn, gloo), held against JAX on
``make_mesh(2, ("pop",))`` of the conftest's CPU devices (the same shard
shapes, so the same step clocks) or against one process.  Each spawning
test gives its ranks at most 100 s; a failing rank makes the launcher
kill the others and raise."""

import numpy as np
import pytest
import torch

from ionflux import eval as JE
from ionflux import parallel as JPar
from ionflux.fit import cmaes as JC
from ionflux.models import nn as JN
from ionflux.models import registry as JR
from ionflux_torch import entry as TEn
from ionflux_torch import eval as TE
from ionflux_torch.fit.train import surface_loss
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.parallel import run_processes

import _multiproc_workers as W
from test_torch_parallel import jax_batch_objective
from _torch_helpers import (assert_close, both_families, jax_net, np_,
                            np_net, torch_net, ts_between_edges)

LIMIT_S = 100.0
GATE_TOL = 1e-4   # tests/test_torch_popsweep.py: currents to 150 x this
TRIPS = 1024


def _two(fn, *args):
    return run_processes(fn, 2, args, backend="gloo", timeout=LIMIT_S)


def test_data_parallel_gradient_matches_one_process():
    """The surface loss's gradient over two ranks' halves of the points,
    all-reduced, against one process's over all of them (1e-6)."""
    rs = np.random.RandomState(0)
    x = (0.3 * rs.randn(32, 2)).astype(np.float32)
    y = (1e-3 * rs.randn(32)).astype(np.float32)
    net = np_net(4, n_nodes=8)
    ranks = _two(W.grad_rank, x, y, net)
    leaves = [torch.tensor(a, requires_grad=True) for wb in net for a in wb]
    want = torch.autograd.grad(surface_loss(
        list(zip(leaves[0::2], leaves[1::2])), torch.from_numpy(x),
        torch.from_numpy(y)), leaves)
    for g0, g1, w in zip(ranks[0], ranks[1], want):
        np.testing.assert_array_equal(g0, g1)
        np.testing.assert_allclose(g0, np_(w), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("form", ["batch", "member"])
def test_shard_objective_two_ranks_match_jax(form):
    """shard_objective over two ranks (4 members each, 7 padded to 8)
    against JAX's on make_mesh(2): both ranks see the same float64 losses,
    within 1e-6 of JAX's (the lockstep solves of
    test_torch_parallel.py)."""
    xs = np.linspace(0.8, 1.2, 28, dtype=np.float32).reshape(7, 4)
    ranks = _two(W.shard_objective_rank, xs, form, 8)
    np.testing.assert_array_equal(ranks[0], ranks[1])
    jkw = ({"batch_fn": jax_batch_objective} if form == "batch"
           else {"per_member_fn": lambda x: jax_batch_objective(x[None])[0]})
    want = JC.shard_objective(JPar.make_mesh(2, ("pop",)), popsize=8,
                              n_params=4, **jkw)(xs)
    assert ranks[0].dtype == np.float64 and ranks[0].shape == (7,)
    np.testing.assert_allclose(ranks[0], want, rtol=0, atol=1e-6)


def test_simulate_population_sharded_two_ranks_match_jax():
    """test_parallel.py's sharded popsweep cut to P = 4 on two ranks (two
    members each, the plain popsweep; its 1,024 trips: 256 fall short of
    the 8 s protocols and every current is inf) against JAX's on
    make_mesh(2) in interpret mode: currents within test_torch_popsweep.py's bound (150 x
    1e-4, off the step edges); every rank holds the whole, and each half
    equals one process's simulate_population of that shard bit for bit."""
    net = np_net(2, members=4)
    levels = (-40.0, 20.0)
    t = np.concatenate([[0.0], np_(ts_between_edges()[1])]).astype(
        np.float32)
    ranks = _two(W.popsweep_rank, net, levels, t, TRIPS)
    (i0, n0), (i1, n1) = ranks
    np.testing.assert_array_equal(i0, i1)
    assert i0.shape == (4, 2, t.size) and np.isfinite(i0).all()
    assert n0 == n1 == 0   # the CPU runs the plain version: no launch
    pj, pt = both_families("activation_protocol", levels)
    for r in range(2):
        shard = [(w[2 * r:2 * r + 2], b[2 * r:2 * r + 2]) for w, b in net]
        alone = TE.simulate_population(
            "nnf", TN.NNfParams(TN.MLP(torch_net(shard)), TR.HH_B06), pt,
            torch.from_numpy(t), TR.SYNTHETIC, trips=TRIPS)
        np.testing.assert_array_equal(i0[2 * r:2 * r + 2], np_(alone))
    want = JE.simulate_population_sharded(
        "nnf", JN.NNfParams(jax_net(net), JR.HH_B06), pj,
        np.asarray(t), JR.SYNTHETIC, mesh=JPar.make_mesh(2, ("pop",)),
        trips=TRIPS, interpret=True)
    assert_close(i0, want, atol=150 * GATE_TOL)


def test_dryrun_multichip_two_processes_on_the_cpu(monkeypatch):
    """dryrun_multichip(2, device='cpu'): a (1, 2) mesh, finite losses and
    currents of JAX's shapes; the data-parallel step's net equals one
    process's Adam step (1e-6)."""
    monkeypatch.setattr(TEn, "DRYRUN_TIMEOUT_S", LIMIT_S)
    out = TEn.dryrun_multichip(2, device="cpu")
    assert out["mesh"] == (1, 2) and out["device"] == "cpu"
    assert np.isfinite(out["loss"]) and np.isfinite(out["pop_losses"]).all()
    assert out["pop_losses"].shape == (4,)
    assert out["i_pop"].shape == (4, 2, 17)
    gen = torch.Generator().manual_seed(0)
    net = TEn.nnf_init(gen, TR.HH_B06, n_layers=1, n_nodes=8,
                       device="cpu").net
    x = torch.randn(32, 2, generator=gen) * 0.3
    y = torch.randn(32, generator=gen) * 1e-3
    leaves = [p.detach().clone().requires_grad_(True)
              for wb in net.layers for p in wb]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    loss = surface_loss(list(zip(leaves[0::2], leaves[1::2])), x, y)
    loss.backward()
    opt.step()
    np.testing.assert_allclose(out["loss"], float(loss.detach()), rtol=1e-6)
    for got, want in zip(out["net"], leaves):
        np.testing.assert_allclose(got, np_(want), rtol=1e-6, atol=1e-9)


def test_a_failing_rank_stops_every_rank():
    """A rank that raises while the other waits in a collective: the
    launcher kills the waiting rank and raises with the traceback."""
    with pytest.raises(RuntimeError, match="(?s)ranks failed.*rank 1: "
                                           ".*ValueError: rank 1 fails"):
        _two(W.failing_rank)
