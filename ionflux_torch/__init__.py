"""ionflux_torch: the PyTorch / CUDA (H100) port of ionflux: so far its
forward simulation path, checkpoint validation on the recordings, the
surface-training recipe (``studies.run_study_validated``,
``scripts/train_d1_torch.py`` / ``train_d2_torch.py``) and the whole-trace
CMA-ES fit (the d0 study, ``scripts/train_d0_torch.py``, with all five of
the JAX script's paths: the lockstep, fused, analytic and native
objectives and the device-resident ``fit.cmaes.cmaes_onchip``), and the
derivative surface on the device (``surface.estimate_gate_surface_ondevice``).
Imports torch, numpy and scipy only; never JAX or ``ionflux``.

Modules mirror ``ionflux``'s layout: ``models``, ``protocols``,
``protorec``, ``observe``, ``solver`` (dopri5, chained, batched,
analytic), ``ops`` (fused solves and their CUDA kernels in ``csrc``,
smoothing, spline, the small eigensolver), ``native`` (the C++ host
solver), ``eval``, ``data``, ``surface``, ``fit``, ``studies``,
``utils.ckpt`` and ``entry``.
"""

__version__ = "0.1.0"
