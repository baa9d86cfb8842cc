"""ionflux_torch: the PyTorch / CUDA (H100) port of ionflux: so far its
forward simulation path and its whole-trace CMA-ES fit (the d0 study,
``scripts/train_d0_torch.py``).  Imports torch and numpy only; never JAX or
``ionflux``.

Modules mirror ``ionflux``'s layout: ``models``, ``protocols``,
``protorec``, ``observe``, ``solver``, ``ops`` (fused solves and their CUDA
kernels in ``csrc``), ``eval``, ``fit``, ``utils.ckpt`` and ``entry``.
"""

__version__ = "0.1.0"
