"""ionflux_torch: the PyTorch / CUDA (H100) port of ionflux: so far its
forward simulation path, checkpoint validation on the recordings, the
surface-training recipe (``studies.run_study_validated``,
``scripts/train_d1_torch.py`` / ``train_d2_torch.py``) and the whole-trace
CMA-ES fit (the d0 study, ``scripts/train_d0_torch.py``).  Imports torch,
numpy and scipy only; never JAX or ``ionflux``.

Modules mirror ``ionflux``'s layout: ``models``, ``protocols``,
``protorec``, ``observe``, ``solver``, ``ops`` (fused solves and their CUDA
kernels in ``csrc``, smoothing), ``eval``, ``data``, ``surface``, ``fit``,
``studies``, ``utils.ckpt`` and ``entry``.
"""

__version__ = "0.1.0"
