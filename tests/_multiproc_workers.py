"""Rank functions of the multi-process parity tests
(test_torch_multiproc.py), run by ``parallel.run_processes`` in spawned
worker processes on the CPU (gloo).  Module-level, so that a worker
imports them by name; no JAX here."""

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch.models.registry import HH_B06

OBJ_TS = np.linspace(0.0, 400.0, 9).astype(np.float32)


def _cpu():
    torch.set_num_threads(1)


def grad_rank(x: np.ndarray, y: np.ndarray, layers) -> list:
    """The surface loss's gradient over a 1-D 'data' mesh: each rank's
    shard of the points, summed by all_reduce."""
    from ionflux_torch.fit.train import surface_loss
    from ionflux_torch.parallel import all_reduce, global_mesh, shard_along

    _cpu()
    mesh = global_mesh(("data",), device="cpu")
    leaves = [torch.tensor(a, requires_grad=True) for wb in layers
              for a in wb]
    loss = surface_loss(list(zip(leaves[0::2], leaves[1::2])),
                        shard_along(mesh, "data", torch.from_numpy(x)),
                        shard_along(mesh, "data", torch.from_numpy(y)))
    return [all_reduce(mesh, "data", g).numpy()
            for g in torch.autograd.grad(loss, leaves)]


def _obj_rhs(t, y, args):
    scale, proto = args
    v = P.voltage(proto, t)
    k1 = scale[:, 0] * float(HH_B06.p1) * torch.exp(float(HH_B06.p2) * v)
    k2 = scale[:, 1] * float(HH_B06.p3) * torch.exp(-float(HH_B06.p4) * v)
    k3 = scale[:, 2] * float(HH_B06.p5) * torch.exp(float(HH_B06.p6) * v)
    k4 = scale[:, 3] * float(HH_B06.p7) * torch.exp(-float(HH_B06.p8) * v)
    dadt = k1 * (1 - y[:, 0]) - k2 * y[:, 0]
    drdt = -k3 * y[:, 1] + k4 * (1 - y[:, 1])
    return torch.stack([dadt, drdt], dim=-1)


def batch_objective(xs: torch.Tensor) -> torch.Tensor:
    """tests/test_multihost.py's lockstep objective: the open probability
    of 4-parameter-scaled HH gates on a +20 mV step, SSE against 0.5."""
    proto = P.activation_protocol(20.0, dt_ms=1.0, device=xs.device)
    ts = torch.as_tensor(OBJ_TS, device=xs.device)
    y0 = torch.tensor([0.0, 1.0], dtype=xs.dtype,
                      device=xs.device).expand(xs.shape[0], 2)
    from ionflux_torch.solver import odeint_batched

    ys = odeint_batched(_obj_rhs, y0, ts, (xs, proto), rtol=1e-5, atol=1e-7,
                        buffer_size=512)
    return torch.sum((ys[:, :, 0] * ys[:, :, 1] - 0.5) ** 2, dim=-1)


def member_objective(x: torch.Tensor) -> torch.Tensor:
    return batch_objective(x[None])[0]


def shard_objective_rank(xs: np.ndarray, form: str, popsize: int):
    from ionflux_torch.fit.cmaes import shard_objective
    from ionflux_torch.parallel import global_mesh

    _cpu()
    mesh = global_mesh(("pop",), device="cpu")
    kw = ({"batch_fn": batch_objective} if form == "batch"
          else {"per_member_fn": member_objective})
    return shard_objective(mesh, popsize=popsize, n_params=4, **kw)(xs)


def popsweep_rank(layers, levels, ts: np.ndarray, trips: int):
    """simulate_population_sharded of an NN-f population over a 'pop'
    mesh, with each rank's popsweep launches counted."""
    from ionflux_torch.eval import simulate_population_sharded
    from ionflux_torch.models.nn import MLP, NNfParams
    from ionflux_torch.models.registry import SYNTHETIC
    from ionflux_torch.ops.fused_solve import fused_nnf_popsweep_solve_ft
    from ionflux_torch.parallel import global_mesh

    _cpu()
    mesh = global_mesh(("pop",), device="cpu")
    pop = NNfParams(MLP([(torch.from_numpy(w), torch.from_numpy(b))
                         for w, b in layers]), HH_B06)
    protos = [P.activation_protocol(float(v), dt_ms=1.0, device="cpu")
              for v in levels]
    n0 = fused_nnf_popsweep_solve_ft.launches
    i = simulate_population_sharded("nnf", pop, protos, torch.from_numpy(ts),
                                    SYNTHETIC, mesh=mesh, trips=trips)
    return i.numpy(), fused_nnf_popsweep_solve_ft.launches - n0


def failing_rank():
    """Rank 1 raises; rank 0 waits in a barrier that never completes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()
