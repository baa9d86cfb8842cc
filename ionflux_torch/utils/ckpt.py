"""Checkpoints and the weight carry-over from the reference package.

The reference writes a model as one ``.npz`` of its parameter leaves in
``jax.tree.leaves`` order (``ionflux/utils/ckpt.py``).  For NN-f/NN-d that
order is the MLP's (W, b) pairs, input layer first, then the 8 HH scalars
p1..p8 (NN-f: the r-gate set; NN-d: the analytic base).  ``params_from_leaves``
turns such a list into the port's ``NNfParams``/``NNdParams``; with a leading
[P] axis on the net leaves it builds a population, whose HH scalars are
shared (member 0's values, as ``eval._pop_shared`` collapses them).

Checkpoints (``save_checkpoint`` / ``load_checkpoint``) and model bundles
(``save_model_bundle``) keep the reference's file layout: an npz of leaves
``leaf_<i>``, a JSON sidecar, the same names, so a file written by one
package loads in the other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ionflux_torch._device import resolve_device
from ionflux_torch.models.nn import MLP, NNdParams, NNfParams
from ionflux_torch.models.registry import HHParams

_N_HH = len(HHParams._fields)


def params_from_leaves(leaves: Sequence[np.ndarray], kind: str,
                       device=None) -> NNfParams | NNdParams:
    """Leaves in ``jax.tree.leaves`` order -> NNfParams ('nnf') or
    NNdParams ('nnd').  Net leaves [in, out]/[out] give one model;
    [P, in, out]/[P, out] give a population of P members."""
    if kind not in ("nnf", "nnd"):
        raise ValueError(f"kind must be 'nnf' or 'nnd', got {kind!r}")
    device = resolve_device(device)
    leaves = [np.asarray(x) for x in leaves]
    net_leaves, hh_leaves = leaves[:-_N_HH], leaves[-_N_HH:]
    if len(hh_leaves) != _N_HH or not net_leaves or len(net_leaves) % 2:
        raise ValueError(
            f"expected (W, b) pairs followed by {_N_HH} HH scalars, got "
            f"{len(leaves)} leaves")
    layers = [(torch.as_tensor(w, dtype=torch.float32, device=device),
               torch.as_tensor(b, dtype=torch.float32, device=device))
              for w, b in zip(net_leaves[0::2], net_leaves[1::2])]
    hh = HHParams(*[np.float32(x.reshape(-1)[0]) for x in hh_leaves])
    net = MLP(layers)
    return NNfParams(net, hh) if kind == "nnf" else NNdParams(net, hh)


def params_to_leaves(params: NNfParams | NNdParams) -> list[np.ndarray]:
    """The inverse of ``params_from_leaves`` (the reference leaf order)."""
    out = []
    for w, b in params.net.layers:
        out += [w.detach().cpu().numpy(), b.detach().cpu().numpy()]
    gate = params.rgate if isinstance(params, NNfParams) else params.hh
    return out + [np.asarray(x, np.float32) for x in gate]


def _leaves(tree) -> list[np.ndarray]:
    """A tree's leaves in the reference order, as numpy: NNfParams /
    NNdParams by ``params_to_leaves``, an MLP as its (W, b) pairs, any other
    tree (lists, tuples, NamedTuples, dicts of tensors) in pytree order."""
    if isinstance(tree, (NNfParams, NNdParams)):
        return params_to_leaves(tree)
    if isinstance(tree, MLP):
        tree = tree.layers
    return [np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                       else x) for x in tree_flatten(tree)[0]]


def save_pytree(path: str, tree) -> None:
    np.savez(path, **{f"leaf_{i}": x for i, x in enumerate(_leaves(tree))})


def _read_leaves(path: str) -> list[np.ndarray]:
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def load_pytree(path: str, kind: str, device=None) -> NNfParams | NNdParams:
    """Load a reference ``model.npz`` (e.g. ``out/d1/model.npz``) as the
    port's parameters, through ``params_from_leaves``."""
    return params_from_leaves(_read_leaves(path), kind, device)


def _kind(template) -> str:
    if isinstance(template, str):
        return template
    return "nnf" if isinstance(template, NNfParams) else "nnd"


def save_checkpoint(dirname: str, params, opt_state, epoch: int,
                    val_losses: list[float], suffix: str = "",
                    is_best: bool = False) -> None:
    """checkpoint<suffix>.{params.npz, opt.npz, json}, copied to
    best-model-checkpoint<suffix>.* when ``is_best``."""
    os.makedirs(dirname, exist_ok=True)
    base = os.path.join(dirname, f"checkpoint{suffix}")
    save_pytree(base + ".params.npz", params)
    save_pytree(base + ".opt.npz", opt_state)
    with open(base + ".json", "w") as fh:
        json.dump({"epoch": epoch, "loss": list(map(float, val_losses))}, fh)
    if is_best:
        best = os.path.join(dirname, f"best-model-checkpoint{suffix}")
        for ext in (".params.npz", ".opt.npz", ".json"):
            shutil.copyfile(base + ext, best + ext)


def load_checkpoint(dirname: str, params_template, opt_template=None,
                    suffix: str = "", best: bool = False, device=None):
    """(params, opt_state, epoch, loss) of a checkpoint.  params_template:
    NNfParams / NNdParams (or 'nnf' / 'nnd'); the params load on
    ``device`` (the card unless asked).  opt_template: a tree of tensors
    whose structure the optimiser state takes, on the template's device."""
    name = ("best-model-checkpoint" if best else "checkpoint") + suffix
    base = os.path.join(dirname, name)
    params = load_pytree(base + ".params.npz", _kind(params_template), device)
    opt_state = None
    if opt_template is not None:
        flat, spec = tree_flatten(opt_template)
        leaves = [torch.as_tensor(x, device=t.device).to(t.dtype)
                  if isinstance(t, torch.Tensor) else type(t)(x)
                  for x, t in zip(_read_leaves(base + ".opt.npz"), flat)]
        opt_state = tree_unflatten(leaves, spec)
    with open(base + ".json") as fh:
        meta = json.load(fh)
    return params, opt_state, meta["epoch"], meta["loss"]


def _jsonable(v):
    """JSON form of a spec field (scalars, tuples, NamedTuple and dataclass
    constants); None for fields with no stable JSON form."""
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, (tuple, list)):
        out = [_jsonable(x) for x in v]
        return out if all(x is not None for x in out) else None
    if hasattr(v, "_asdict"):
        return {k: _jsonable(x) for k, x in v._asdict().items()}
    if hasattr(v, "__dict__") and v.__dict__:
        return {k: _jsonable(x) for k, x in v.__dict__.items()}
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def save_model_bundle(path: str, params, spec=None) -> None:
    """A self-describing model: the params npz plus ``<stem>.spec.json``
    with the study spec's fields (null where a field has no JSON form)."""
    save_pytree(path, params)
    meta = {}
    if spec is not None:
        for k, v in getattr(spec, "__dict__", {}).items():
            meta[k] = _jsonable(v)
    stem = path[:-4] if path.endswith(".npz") else path
    with open(stem + ".spec.json", "w") as fh:
        json.dump({"params_file": os.path.basename(path), **meta}, fh,
                  indent=1)
