"""Fitting loops of the port: ``cmaes`` (host CMA-ES on whole traces, and
``cmaes_onchip``, the same strategy device-resident) and ``train`` (Adam on
the derivative surface)."""

from ionflux_torch.fit.cmaes import cmaes_onchip
from ionflux_torch.fit.train import (TrainResult, fit_surface, pretrain,
                                     surface_loss)

__all__ = ["cmaes_onchip", "fit_surface", "pretrain", "surface_loss",
           "TrainResult"]
