"""The port's driver entry points (counterpart of ``__graft_entry__``):
``entry``, the forward step on the flagship model (an NN-f neural-ODE
current simulation over an activation protocol), and ``dryrun_multichip``,
the multi-device dry run over a process group."""

from __future__ import annotations

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch._device import resolve_device
from ionflux_torch.eval import simulate
from ionflux_torch.models import nnf_init
from ionflux_torch.models.nn import NNfParams
from ionflux_torch.models.registry import HH_B06, SYNTHETIC


def entry(device=None):
    """(fn, example_args): fn(params, proto, ts) -> currents [T], with a
    seeded full-width NN-f net, a +20 mV activation protocol and 1601
    output times over 8 s."""
    device = resolve_device(device)
    params = nnf_init(torch.Generator().manual_seed(0), HH_B06,
                      device=device)
    proto = P.activation_protocol(20.0, device=device)
    ts = torch.linspace(0.0, 8000.0, 1601, dtype=torch.float32,
                        device=device)

    def fn(params, proto, ts):
        return simulate("nnf", params, proto, ts, SYNTHETIC, rtol=1e-5,
                        atol=1e-7, buffer_size=2048)

    return fn, (params, proto, ts)


DRYRUN_TIMEOUT_S = 600.0


def _rhs_hh_pop(t, y, args):
    """The HH a/r gates of a population of parameter sets ps [B, 8] on one
    protocol: the dry run's lockstep objective."""
    ps, proto = args
    v = P.voltage(proto, t)
    k1 = ps[:, 0] * torch.exp(ps[:, 1] * v)
    k2 = ps[:, 2] * torch.exp(-ps[:, 3] * v)
    k3 = ps[:, 4] * torch.exp(ps[:, 5] * v)
    k4 = ps[:, 6] * torch.exp(-ps[:, 7] * v)
    dadt = k1 * (1.0 - y[:, 0]) - k2 * y[:, 0]
    drdt = -k3 * y[:, 1] + k4 * (1.0 - y[:, 1])
    return torch.stack([dadt, drdt], dim=-1)


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of ``dryrun_multichip`` (already in the process group):
    the data-parallel surface step, the sharded lockstep objective and the
    sharded popsweep, at JAX's tiny shapes."""
    from ionflux_torch.fit.cmaes import shard_objective
    from ionflux_torch.fit.train import surface_loss
    from ionflux_torch.eval import simulate_population_sharded
    from ionflux_torch.models.nn import MLP
    from ionflux_torch.ops.fused_solve import fused_nnf_popsweep_solve_ft
    from ionflux_torch.parallel import (all_reduce, global_mesh, replicate,
                                        shard_along)
    from ionflux_torch.solver import odeint_batched

    # 2-D mesh when possible so both axes carry real shardings
    if n_devices % 2 == 0 and n_devices > 1:
        mesh_shape = (n_devices // 2, 2)
    else:
        mesh_shape = (n_devices, 1)
    mesh = global_mesh(("data", "pop"), mesh_shape, device=device)
    dev = mesh.device
    n_points, n_t = 16 * n_devices, 17

    # --- data axis: a data-parallel surface-loss Adam step, the gradient
    # all-reduced over 'data' (the loss is a sum over points)
    gen = torch.Generator().manual_seed(0)
    net = replicate(mesh, nnf_init(gen, HH_B06, n_layers=1, n_nodes=8,
                                   device="cpu").net)
    x = torch.randn(n_points, 2, generator=gen) * 0.3
    y = torch.randn(n_points, generator=gen) * 1e-3
    leaves = [p.detach().clone().requires_grad_(True)
              for wb in net.layers for p in wb]
    layers = list(zip(leaves[0::2], leaves[1::2]))
    loss = surface_loss(layers, shard_along(mesh, "data", x),
                        shard_along(mesh, "data", y))
    grads = torch.autograd.grad(loss, leaves)
    grads = [all_reduce(mesh, "data", g) for g in grads]
    loss = all_reduce(mesh, "data", loss.detach())
    opt = torch.optim.Adam(leaves, lr=1e-3)
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.step()
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("training-step loss not finite")

    # --- pop axis: shard_objective(batch_fn=...) over the lockstep
    # odeint_batched HH objective, on a 1-D 'pop' view of the same ranks
    pop_mesh = global_mesh(("pop",), device=device)
    proto = P.activation_protocol(0.0, dt_ms=1.0, device=dev)
    ts = torch.linspace(0.0, 800.0, n_t, dtype=torch.float32, device=dev)
    v_ts = P.voltage(proto, ts)
    y0 = torch.tensor([0.0, 1.0], dtype=torch.float32, device=dev)

    def batch_obj(xs):
        ys = odeint_batched(_rhs_hh_pop, y0.expand(xs.shape[0], 2), ts,
                            (xs, proto), rtol=1e-4, atol=1e-6,
                            buffer_size=512)
        i_sim = ys[:, :, 0] * ys[:, :, 1] * (v_ts[None] - float(
            SYNTHETIC.e))
        sse = torch.sum(i_sim ** 2, dim=1)
        return torch.where(torch.isfinite(sse), sse,
                           torch.full_like(sse, float("inf")))

    objective = shard_objective(pop_mesh, batch_fn=batch_obj,
                                popsize=2 * n_devices, n_params=8)
    pop_p2 = np.stack([np.array([p * (1.0 + 0.01 * i) for p in HH_B06],
                                np.float32) for i in range(2 * n_devices)])
    pop_losses = objective(pop_p2)
    if not np.all(np.isfinite(pop_losses)):
        raise RuntimeError(f"rollout losses not finite: {pop_losses}")

    # --- the popsweep kernel sharded over 'pop': one launch a rank
    gen = torch.Generator().manual_seed(2)
    members = [nnf_init(gen, HH_B06, n_layers=1, n_nodes=8,
                        device="cpu").net.layers
               for _ in range(2 * n_devices)]
    pop = NNfParams(MLP([(torch.stack([m[k][0] for m in members]),
                          torch.stack([m[k][1] for m in members]))
                         for k in range(len(members[0]))]), HH_B06)
    protos = [proto, P.activation_protocol(20.0, dt_ms=1.0, device=dev)]
    n0 = fused_nnf_popsweep_solve_ft.launches
    i_pop = simulate_population_sharded("nnf", pop, protos, ts, SYNTHETIC,
                                        mesh=pop_mesh, trips=256)
    launches = fused_nnf_popsweep_solve_ft.launches - n0
    i_pop = i_pop.cpu().numpy()
    if i_pop.shape != (2 * n_devices, 2, n_t) or not np.isfinite(
            i_pop).all():
        raise RuntimeError(f"sharded popsweep currents {i_pop.shape} not "
                           "finite")
    return {"mesh": mesh_shape, "device": str(dev), "loss": float(loss),
            "grads": [g.cpu().numpy() for g in grads],
            "net": [p.detach().cpu().numpy() for p in leaves],
            "pop_losses": pop_losses, "i_pop": i_pop,
            "popsweep_launches": launches}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The multi-device dry run (counterpart of
    ``__graft_entry__.dryrun_multichip``): ``n_devices`` processes in one
    process group (``parallel.run_processes``), each on its own rank of a
    (data, pop) mesh, run one data-parallel surface-loss Adam step (the
    gradient all-reduced), ``fit.cmaes.shard_objective(batch_fn=...)``
    over the lockstep ``odeint_batched`` HH objective, and
    ``eval.simulate_population_sharded`` of 2 n one-layer 8-wide nets on
    two activation protocols (the popsweep, one launch a rank).

    Runs on the card unless ``device="cpu"`` (JAX forces a virtual CPU
    mesh); ranks that share one card use gloo.  A rank that fails makes
    this raise.  Returns rank 0's results (``loss``, ``grads``, ``net``
    after the step, ``pop_losses``, ``i_pop``, ``popsweep_launches``,
    ``mesh``); every rank must agree on the losses and currents."""
    from ionflux_torch.parallel import run_processes

    dev = resolve_device(device)
    backend = None
    if dev.type == "cuda":
        from ionflux_torch.ops import _build

        _build.build(["fused_solve"])   # before the ranks start
    else:
        backend = "gloo"
    ranks = run_processes(_dryrun_rank, n_devices, (n_devices, dev.type),
                          backend=backend, timeout=DRYRUN_TIMEOUT_S)
    first = ranks[0]
    for r, out in enumerate(ranks[1:], 1):
        if not (np.array_equal(out["pop_losses"], first["pop_losses"])
                and np.array_equal(out["i_pop"], first["i_pop"])
                and out["loss"] == first["loss"]):
            raise RuntimeError(f"dryrun_multichip: rank {r} disagrees with "
                               "rank 0")
    print(f"dryrun_multichip ok: mesh={first['mesh']} axes=(data,pop) on "
          f"{first['device']} loss={first['loss']:.4e} "
          f"pop_losses[:2]={first['pop_losses'][:2]} (shard_objective+"
          f"odeint_batched over {n_devices} processes; sharded popsweep "
          f"{first['i_pop'].shape} ok, "
          f"{[r['popsweep_launches'] for r in ranks]} launches a rank)")
    return first
