"""The Mosaic bias-broadcast probe (counterpart of the Pallas kernel of
``scripts/probe_mosaic_bias_fault.py``).

The probe reproduced a TPU compiler fault: a [P, 1, M] bias broadcast onto
a batched [P, Q, 2] x [P, 2, M] product inside a loop.  It computes, for
``TRIPS`` steps over acc [P, Q] (from 0.1),

    h = [acc, 1 - acc] @ w[:, :2, :] + b[:, None, :]           (fold=False)
    h = [acc, 1 - acc, 1] @ [w[:, :2, :]; b[:, None, :]]       (fold=True)
    acc = tanh(h[:, :, 0] + 1e-3 acc)

and returns [P, 128]: acc in the first Q = ROWS columns, zeros after.  The
two cases compute the same function; they differ in where the bias enters.

``bias_probe`` sends a CPU tensor to ``bias_probe_plain`` and a CUDA tensor
to the hand-written kernel in ``csrc/bias_probe.cu``; ``bias_probe.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from ionflux_torch.ops._build import count_launch

ROWS, TRIPS, OUT_COLS = 16, 64, 128


def _check(w: torch.Tensor, b: torch.Tensor) -> None:
    for name, x, dim in (("w", w, 3), ("b", b, 2)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
        if x.dim() != dim:
            raise ValueError(f"{name} must have {dim} dims, got "
                             f"{tuple(x.shape)}")
    p, three, m = w.shape
    if three != 3 or tuple(b.shape) != (p, m):
        raise ValueError(f"w must be [P, 3, M] and b [P, M]; got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if b.device != w.device:
        raise ValueError(f"w is on {w.device}, b on {b.device}")


def bias_probe_plain(w: torch.Tensor, b: torch.Tensor,
                     fold: bool = False) -> torch.Tensor:
    """The probe in PyTorch ops, in float32, on any device."""
    _check(w, b)
    if w.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain probe is float32; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    p = w.shape[0]
    acc = torch.full((p, ROWS), 0.1, dtype=torch.float32, device=w.device)
    wb = torch.cat([w[:, :2, :], b[:, None, :]], dim=1)       # [P, 3, M]
    for _ in range(TRIPS):
        if fold:
            x = torch.stack([acc, 1.0 - acc, torch.ones_like(acc)], dim=-1)
            h = torch.bmm(x, wb)
        else:
            x = torch.stack([acc, 1.0 - acc], dim=-1)
            h = torch.bmm(x, w[:, :2, :]) + b[:, None, :]
        acc = torch.tanh(h[:, :, 0] + 1e-3 * acc)
    return torch.cat([acc, acc.new_zeros((p, OUT_COLS - ROWS))], dim=1)


def bias_probe(w: torch.Tensor, b: torch.Tensor,
               fold: bool = False) -> torch.Tensor:
    """The probe: out [P, 128].  CUDA tensors run the kernel (one thread
    per member and row, P x ROWS threads in one launch); CPU tensors run
    ``bias_probe_plain``.  Raises on a refused launch; never
    synchronises."""
    if not w.is_cuda:
        return bias_probe_plain(w, b, fold)
    _check(w, b)
    from ionflux_torch.ops._build import launch

    w, b = w.contiguous(), b.contiguous()
    p, _, m = w.shape
    out = torch.empty((p, OUT_COLS), dtype=torch.float32, device=w.device)
    launch("bias_probe", "ionflux_bias_probe", w.device, w.data_ptr(),
           b.data_ptr(), out.data_ptr(), p, ROWS, m, TRIPS, int(fold))
    count_launch(bias_probe)
    return out


bias_probe.launches = 0
