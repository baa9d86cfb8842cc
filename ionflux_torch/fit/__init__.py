"""Fitting loops of the port: ``cmaes`` (host CMA-ES on whole traces)."""
