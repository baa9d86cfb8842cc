"""Fitting loops of the port: ``cmaes`` (host CMA-ES on whole traces) and
``train`` (Adam on the derivative surface)."""

from ionflux_torch.fit.train import (TrainResult, fit_surface, pretrain,
                                     surface_loss)

__all__ = ["fit_surface", "pretrain", "surface_loss", "TrainResult"]
