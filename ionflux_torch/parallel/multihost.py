"""Multi-process meshes (counterpart of ``ionflux/parallel/multihost.py``).

The driver pattern is JAX's, SPMD: every process runs the same program
(the same CMA-ES seed, so every process proposes the same population),
calls :func:`init_multihost` first, builds the mesh with
:func:`global_mesh` and hands it to ``fit.cmaes.shard_objective`` or
``eval.simulate_population_sharded``.  Each process is one device.

The backend is chosen, and printed, when the group starts: NCCL when every
rank has a card of its own, gloo otherwise (the CPU; two ranks sharing one
card, which NCCL refuses).  With gloo the gathers go through host memory;
that is a choice of transport, the compute stays on the device, and a
failed collective raises.  JAX's ``local_cpu_devices`` has no counterpart:
a process is one device.

:func:`run_processes` starts such a program in local worker processes
("spawn"), with a time limit on joining the group and on the whole run; a
worker that fails or hangs makes it kill every worker and raise.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ionflux_torch.parallel.mesh import (Mesh, all_gather, make_mesh,
                                         shard_along)

JOIN_TIMEOUT_S = 120.0


def _env_int(name: str):
    value = os.environ.get(name)
    return int(value) if value else None


def choose_backend(num_processes: int) -> str:
    """NCCL when this host has a card for every rank, else gloo."""
    if torch.cuda.is_available() and (torch.cuda.device_count()
                                      >= num_processes):
        return "nccl"
    return "gloo"


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> str:
    """Join this process to a process group of ``num_processes``, as rank
    ``process_id``, at ``coordinator_address`` (host:port, or a URL).  The
    three default to IONFLUX_COORDINATOR / IONFLUX_NUM_PROCS /
    IONFLUX_PROC_ID, as JAX's do.  ``backend`` defaults to
    :func:`choose_backend`.  Returns the backend."""
    coordinator_address = coordinator_address or os.environ.get(
        "IONFLUX_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("IONFLUX_NUM_PROCS")
    if process_id is None:
        process_id = _env_int("IONFLUX_PROC_ID")
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "init_multihost needs the coordinator address, the number of "
            "processes and this process's id (arguments, or "
            "IONFLUX_COORDINATOR / IONFLUX_NUM_PROCS / IONFLUX_PROC_ID)")
    backend = backend or choose_backend(num_processes)
    print(f"init_multihost: rank {process_id} of {num_processes}, backend "
          f"{backend}", flush=True)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    return backend


def global_mesh(axes: tuple[str, ...] = ("pop",),
                shape: tuple[int, ...] | None = None, device=None) -> Mesh:
    """The mesh over every process of the group, rank-major, on this
    rank's device (the card unless the caller asks for the CPU)."""
    return make_mesh(None, axes, shape, device)


def scatter_global(mesh: Mesh, x_full: np.ndarray, dim: int = 0,
                   axis: str | None = None) -> torch.Tensor:
    """This rank's shard, on its device, of a host array every process
    holds whole (the SPMD replicated-driver case)."""
    axis = axis or mesh.axis_names[0]
    return shard_along(mesh, axis, torch.as_tensor(np.asarray(x_full)), dim)


def gather_global(mesh: Mesh, x: torch.Tensor, dim: int = 0,
                  axis: str | None = None) -> np.ndarray:
    """Every rank's shard along ``axis`` gathered on ``dim``, as host numpy
    on every process."""
    axis = axis or mesh.axis_names[0]
    return all_gather(mesh, axis, x, dim).cpu().numpy()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(fn, args, rank: int, n: int, address: str, backend, out):
    try:
        init_multihost(address, n, rank, backend)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, value))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_processes(fn, n_procs: int, args=(), *, backend: str | None = None,
                  timeout: float = 300.0) -> list:
    """``fn(*args)`` in ``n_procs`` new processes ("spawn"), each joined to
    one process group first (:func:`init_multihost` on a free local
    port).  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function).  Returns each rank's result, by rank.  A worker that raises,
    exits without a result or outlasts ``timeout`` seconds makes this kill
    every worker and raise ``RuntimeError``."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, args, r, n_procs, address, backend, out))
             for r in range(n_procs)]
    for p in procs:
        p.start()
    results, failed = {}, {}
    deadline = time.monotonic() + timeout
    grace = None     # after a failure, the others' reports, for 5 s
    try:
        while len(results) + len(failed) < n_procs:
            now = time.monotonic()
            if (grace is not None and now > grace) or now > deadline:
                if not failed:
                    failed[None] = (f"timed out after {timeout:.0f} s with "
                                    f"ranks {sorted(results)} done")
                break
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if (p.exitcode not in (None, 0) and r not in results
                            and r not in failed):
                        failed[r] = (f"exited with code {p.exitcode} and "
                                     "no result")
                if failed and grace is None:
                    grace = time.monotonic() + 5.0
                continue
            if ok:
                results[rank] = value
            else:
                failed[rank] = value
                grace = grace or time.monotonic() + 5.0
        if not failed:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    if failed:
        raise RuntimeError(f"run_processes: {len(failed)} of {n_procs} "
                           "ranks failed:\n" + "\n".join(
                               f"rank {r}: {text}" for r, text in
                               sorted(failed.items(), key=lambda kv: str(
                                   kv[0]))))
    return [results[r] for r in range(n_procs)]
