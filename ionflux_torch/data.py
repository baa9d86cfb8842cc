"""Synthetic study data (counterpart of ``ionflux/data.py``): ground-truth
currents of the HH or Markov model on the training step protocols, plus the
reference's measurement noise, drawn from numpy's legacy ``RandomState`` in
the reference's order (7 activation sweeps, then 9 deactivation sweeps), so
both packages add the same noise.
"""

from __future__ import annotations

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch.eval import simulate
from ionflux_torch.models.registry import Constants, MarkovParams, SYNTHETIC
from ionflux_torch.observe import NOISE_SIGMA


def simulate_current(params, proto: P.Protocol, ts: torch.Tensor,
                     c: Constants = SYNTHETIC, rtol=1e-6,
                     atol=1e-8) -> torch.Tensor:
    """Ground-truth current [T] of an HH (2-state) or Markov (6-state)
    model from its rest state, on ts' device (``eval.simulate``)."""
    kind = "markov" if isinstance(params, MarkovParams) else "hh"
    return simulate(kind, params, proto, ts, c, rtol=rtol, atol=atol)


def simulate_family(params, protos: list[P.Protocol], ts: torch.Tensor,
                    c: Constants = SYNTHETIC,
                    vmapped: bool = False) -> torch.Tensor:
    """Ground-truth currents [B, T] of a same-length protocol family, one
    solve per protocol.  ``vmapped`` is accepted for the reference's
    signature and takes the same loop: a batched solve would share one step
    clock and change the results."""
    return torch.stack([simulate_current(params, pr, ts, c) for pr in protos])


def noise_sequence(shapes, sigma: float = NOISE_SIGMA, seed: int = 0):
    """The reference's noise draws: RandomState(seed), then one
    normal(0, sigma, shape) per protocol in order."""
    rs = np.random.RandomState(seed)
    return [rs.normal(0.0, sigma, s) for s in shapes]


def synth_study_currents(gt_params, act_ts: torch.Tensor,
                         deact_ts: torch.Tensor, c: Constants = SYNTHETIC,
                         seed: int = 0):
    """Noisy training currents of the 7 activation and 9 deactivation
    sweeps (0.1 ms protocols) -> (act [7, T1], deact [9, T2]) numpy f64.
    The protocols are built on act_ts' device."""
    dev = act_ts.device
    act = simulate_family(gt_params, P.activation_family(device=dev), act_ts,
                          c).double().cpu().numpy()
    deact = simulate_family(gt_params, P.deactivation_family(device=dev),
                            deact_ts, c).double().cpu().numpy()
    noises = noise_sequence([tuple(act_ts.shape)] * act.shape[0]
                            + [tuple(deact_ts.shape)] * deact.shape[0],
                            seed=seed)
    act += np.stack(noises[:act.shape[0]])
    deact += np.stack(noises[act.shape[0]:])
    return act, deact
