"""Process-grid parallelism on ``torch.distributed`` (counterpart of
``ionflux/parallel/mesh.py``).

JAX drives a grid of devices from one program.  The port's idiom is one
process per device, so a mesh here is a grid of process ranks with axis
names, and every process holds its own rank's shard.  The axes are JAX's:
``data`` (surface points, protocols, sweeps) and ``pop`` (population
members, architecture configs).

- ``make_mesh`` lays the process group's ranks out as a grid (one rank,
  this process, where no group is initialised);
- ``shard_along`` returns this rank's shard of a tensor every rank holds
  in full (the SPMD driver: each rank proposed the same population);
- ``replicate`` puts a tree of parameters on this rank's device;
- ``sharded_map(mesh, axis, fn)`` runs ``fn`` on this rank's shard and
  gathers the results along the axis, so every rank returns the whole.

``all_gather`` and ``all_reduce`` run over one axis of the mesh.  The gloo
backend takes host tensors, so with gloo a CUDA tensor goes through host
memory for the collective; the compute stays on the card.  A collective
that fails raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ionflux_torch._device import resolve_device
from ionflux_torch.models.nn import MLP


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) with no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` (the card unless the caller asks for
    the CPU), a card of its own by rank where no index is given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", world()[0] % torch.cuda.device_count())
    return dev


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of process ranks with axis names.  ``devices`` is the grid of
    global ranks (JAX's ``Mesh.devices``: its shape is the mesh's),
    ``device`` this process's device, ``groups`` the process group of this
    rank's line along each axis (None: the default group, or an axis of
    one rank)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    device: torch.device
    groups: dict

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        pos = np.argwhere(self.devices == world()[0])[0]
        return int(pos[self.axis_names.index(axis)])


def _axis_groups(ranks: np.ndarray, axes: tuple[str, ...]) -> dict:
    """The process group of this rank's line along each axis.  Every rank
    creates every line's group, in the same order, as torch.distributed
    requires."""
    me, n = world()
    groups = {}
    for k, ax in enumerate(axes):
        size = ranks.shape[k]
        if size == 1 or size == n:
            groups[ax] = None
            continue
        lines = np.moveaxis(ranks, k, -1).reshape(-1, size)
        mine, _ = dist.new_subgroups_by_enumeration(
            [line.tolist() for line in lines])
        groups[ax] = mine
    return groups


def make_mesh(n_devices: int | None = None,
              axes: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None, device=None) -> Mesh:
    """A mesh over every process of the group, ranks in row-major order.
    ``n_devices`` must be the group's size: a process is a device, and a
    mesh never runs on fewer ranks than asked.  ``shape`` defaults to
    (n, 1, ...)."""
    _, n = world()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"processes; this process group has {n}")
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} over axes {axes} does not "
                         f"hold {n} ranks")
    ranks = np.arange(n).reshape(shape)
    groups = (_axis_groups(ranks, tuple(axes)) if n > 1
              else {ax: None for ax in axes})
    return Mesh(ranks, tuple(axes), rank_device(device), groups)


def _via_host(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor,
               dim: int = 0) -> torch.Tensor:
    """The shards of every rank on this rank's line along ``axis``,
    concatenated on ``dim`` in the axis's order."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    src = t.detach().contiguous()
    host = _via_host(src)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.groups[axis])
    out = torch.cat(parts, dim)
    return out.to(t.device) if host else out


def all_reduce(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over this rank's line along ``axis``."""
    if mesh.shape[axis] == 1:
        return t
    buf = t.detach().clone()
    host = _via_host(buf)
    if host:
        buf = buf.cpu()
    dist.all_reduce(buf, group=mesh.groups[axis])
    return buf.to(t.device) if host else buf


def shard_along(mesh: Mesh, axis: str, x: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """This rank's shard of ``x`` (which every rank holds whole) along mesh
    axis ``axis`` on dim ``dim``, on the mesh's device.  The dim must divide
    evenly."""
    n = mesh.shape[axis]
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not divide over "
                         f"the {n}-rank '{axis}' axis")
    k = size // n
    return x.narrow(dim, mesh.index(axis) * k, k).to(mesh.device)


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, MLP):
        return MLP([(w.to(device), b.to(device)) for w, b in x.layers])
    return x


def replicate(mesh: Mesh, tree):
    """A tree of tensors (parameters, an ``MLP``) on this rank's device:
    every rank holds the whole."""
    return tree_map(lambda x: _to(x, mesh.device), tree)


def pad_to_multiple(x: np.ndarray, m: int, axis: int = 0):
    """Pad dim ``axis`` up to a multiple of ``m`` by repeating its last
    entry (for even sharding).  Returns (padded, original_length)."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge"), n


def sharded_map(mesh: Mesh, axis: str, fn: Callable) -> Callable:
    """``fn`` over one mesh axis: the returned function takes a tree of
    tensors that every rank holds whole, runs ``fn`` on this rank's shard
    of each (dim 0), and gathers its tensor result along the axis.  With
    no process group the mesh is this one rank and this is ``fn``."""
    if world()[1] == 1:
        return fn

    def run(x):
        shard = tree_map(lambda t: shard_along(mesh, axis, t)
                         if isinstance(t, torch.Tensor) else t, x)
        return all_gather(mesh, axis, fn(shard))

    return run
