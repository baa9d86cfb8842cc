"""K2: eigendecomposition of small symmetric matrices by cyclic Jacobi (no
Pallas counterpart: it stands in for ``jnp.linalg.eigh`` inside
``ionflux/fit/cmaes.py::cmaes_onchip``, whose covariance is n x n, n = 4
for the d0 fit).

``torch.linalg.eigh`` on a CUDA tensor reads its status on the host after
the solve: a CUDA graph capture refuses that, and it would put a host round
trip into every CMA-ES generation.  ``sym_eig`` makes no host read.

Sweeps over the pairs p < q in row order rotate each pair whose |a_pq| is
above 1e-8 sqrt(|a_pp a_qq|) to zero (A <- J^T A J, V <- V J, Golub & Van
Loan Alg. 8.5.2) until a sweep rotates nothing or ``MAX_SWEEPS`` have run;
the eigenvalues come back ascending (stably sorted) with V's columns, as
``torch.linalg.eigh`` returns them.  Eigenvectors are fixed up to sign.

``sym_eig`` sends a CPU tensor to ``sym_eig_plain`` and a CUDA tensor to the
kernel in ``csrc/sym_eig.cu`` (one warp per matrix); ``sym_eig.launches``
counts kernel launches.  The kernel rounds every product and sum on its own
in the plain version's order, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from ionflux_torch.ops._build import count_launch

MAX_N = 16
MAX_SWEEPS = 32


def _check(a: torch.Tensor) -> None:
    if not isinstance(a, torch.Tensor) or a.dtype != torch.float32:
        raise TypeError("sym_eig takes a float32 torch.Tensor")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"sym_eig takes [..., n, n], got {tuple(a.shape)}")
    if not 1 <= a.shape[-1] <= MAX_N:
        raise ValueError(f"sym_eig takes n <= {MAX_N}, got {a.shape[-1]}")


def sym_eig_plain(a: torch.Tensor, max_sweeps: int = MAX_SWEEPS):
    """(w [..., n] ascending, v [..., n, n]) of symmetric a, in float32
    PyTorch ops over the whole batch at once; one host read per sweep (its
    stop test).  ``sym_eig_plain.last_sweeps`` holds the sweeps it ran (the
    last one rotated nothing, or was the max_sweeps-th)."""
    _check(a)
    shp, n = a.shape[:-2], a.shape[-1]
    a = a.reshape(-1, n, n).clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).repeat(a.shape[0], 1, 1)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for sweep in range(max_sweeps):
        sym_eig_plain.last_sweeps = sweep + 1
        rotated = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = a[:, p, p], a[:, q, q], a[:, q, p]
                thr = 1e-8 * torch.sqrt(torch.abs(app * aqq))
                rot = torch.abs(apq) > thr
                theta = (aqq - app) / (2.0 * torch.where(rot, apq, one))
                root = torch.sqrt(theta * theta + 1.0)
                t = torch.where(theta >= 0.0, 1.0 / (theta + root),
                                -1.0 / (-theta + root))
                c = torch.where(rot, 1.0 / torch.sqrt(t * t + 1.0), one)
                s = torch.where(rot, t * c, zero)
                c, s = c[:, None], s[:, None]
                x, y = a[:, :, p].clone(), a[:, :, q].clone()
                a[:, :, p] = torch.where(rot[:, None], c * x - s * y, x)
                a[:, :, q] = torch.where(rot[:, None], s * x + c * y, y)
                x, y = a[:, p, :].clone(), a[:, q, :].clone()
                a[:, p, :] = torch.where(rot[:, None], c * x - s * y, x)
                a[:, q, :] = torch.where(rot[:, None], s * x + c * y, y)
                a[:, p, q] = torch.where(rot, zero, a[:, p, q])
                a[:, q, p] = torch.where(rot, zero, a[:, q, p])
                x, y = v[:, :, p].clone(), v[:, :, q].clone()
                v[:, :, p] = torch.where(rot[:, None], c * x - s * y, x)
                v[:, :, q] = torch.where(rot[:, None], s * x + c * y, y)
                rotated |= rot
        if not bool(rotated.any()):
            break
    w, order = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1,
                          stable=True)
    v = torch.take_along_dim(v, order[:, None, :], dim=2)
    return w.reshape(shp + (n,)), v.reshape(shp + (n, n))


def sym_eig(a: torch.Tensor, max_sweeps: int = MAX_SWEEPS):
    """(w [..., n] ascending, v [..., n, n]) with a = v diag(w) v^T for
    symmetric a [..., n, n], n <= 16.  CUDA tensors run the kernel (one
    warp per matrix, no host read: capturable); CPU tensors run
    ``sym_eig_plain``.  Raises on a refused launch; never synchronises."""
    if not a.is_cuda:
        return sym_eig_plain(a, max_sweeps)
    _check(a)
    from ionflux_torch.ops._build import launch

    shp, n = a.shape[:-2], a.shape[-1]
    a = a.reshape(-1, n, n).contiguous()
    w = torch.empty((a.shape[0], n), dtype=a.dtype, device=a.device)
    v = torch.empty_like(a)
    launch("sym_eig", "ionflux_sym_eig", a.device, a.data_ptr(),
           w.data_ptr(), v.data_ptr(), a.shape[0], n, max_sweeps)
    count_launch(sym_eig)
    return w.reshape(shp + (n,)), v.reshape(shp + (n, n))


sym_eig.launches = 0
sym_eig_plain.last_sweeps = 0
