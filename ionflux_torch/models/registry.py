"""Parameter sets and observation constants of the forward-simulation path.

Copied from ``ionflux/models/registry.py`` (which the port may not import:
importing anything under ``ionflux`` pulls in JAX).  Values are host-side
``numpy.float32`` scalars, exactly as in the reference, so both packages
feed the same f32 numbers into their right-hand sides.  Rates are in ms^-1
and mV^-1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class HHParams(NamedTuple):
    """8-parameter HH IKr: k1=p1*exp(p2*V), k2=p3*exp(-p4*V) for the a-gate;
    k3=p5*exp(p6*V), k4=p7*exp(-p8*V) for the r-gate."""

    p1: float
    p2: float
    p3: float
    p4: float
    p5: float
    p6: float
    p7: float
    p8: float


class MarkovParams(NamedTuple):
    """12-parameter 3-state Markov chain (``models/markov.py``): a1, b1
    from p1-p4, the r-gate rates bh, ah from p5-p8 (also ``HH_D_RGATE`` and
    ``HH_D2_BASE``), a2, b2 from p9-p12."""

    p1: float
    p2: float
    p3: float
    p4: float
    p5: float
    p6: float
    p7: float
    p8: float
    p9: float
    p10: float
    p11: float
    p12: float


class Constants(NamedTuple):
    """Observation constants: I = g * a * r * (V - e)."""

    g: float  # conductance
    e: float  # reversal potential, mV


def _hh(*vals) -> HHParams:
    return HHParams(*[np.float32(v) for v in vals])


def _markov(*vals) -> MarkovParams:
    return MarkovParams(*[np.float32(v) for v in vals])


# Candidate HH, hERG25oC1 cell B06 (train-s1.py:139-146), s^-1 -> ms^-1.
HH_B06 = _hh(
    1.12592345582957387e-01 * 1e-3,
    8.26751134920666146e+01 * 1e-3,
    3.38768033864048357e-02 * 1e-3,
    4.67106147665183542e+01 * 1e-3,
    8.47769667061995875e+01 * 1e-3,
    2.04001345352499328e+01 * 1e-3,
    1.02860743916105211e+01 * 1e-3,
    2.78201179336874098e+01 * 1e-3,
)

# 3-state Markov ground truth, cell B06 M10 fit (train-d1.py:139-150).
MARKOV_B06 = _markov(
    5.94625498751561316e-02 * 1e-3,
    1.21417701632850410e+02 * 1e-3,
    4.76436985414236425e+00 * 1e-3,
    3.49383233960778904e-03 * 1e-3,
    9.62243079990877703e+01 * 1e-3,
    2.26404683824047979e+01 * 1e-3,
    8.00924780462999131e+00 * 1e-3,
    2.43749808069009823e+01 * 1e-3,
    2.06822607368134157e+02 * 1e-3,
    3.30791433507312362e+01 * 1e-3,
    1.26069071928587784e+00 * 1e-3,
    2.24844970727316245e+01 * 1e-3,
)

# The Markov r-gate expressed as HH p5-p8 (the d-study NN models).
HH_D_RGATE = (MARKOV_B06.p5, MARKOV_B06.p6, MARKOV_B06.p7, MARKOV_B06.p8)

# d2's initial NN-d analytic base: B06 a-gate + Markov M10 r-gate.  A trained
# d2 checkpoint carries its own fitted base (its 8 trailing leaves).
HH_D2_BASE = _hh(
    HH_B06.p1, HH_B06.p2, HH_B06.p3, HH_B06.p4,
    MARKOV_B06.p5, MARKOV_B06.p6, MARKOV_B06.p7, MARKOV_B06.p8,
)

# d0 candidate-fit initial guess, the analytic part of the d-studies'
# r-gate (train-d0.py:326-334; p5-p8 are the Markov M10 values).
HH_D0_INIT = _hh(
    1.13e-4, 7.45e-2, 3.60e-5, 4.49e-2,
    MARKOV_B06.p5, MARKOV_B06.p6, MARKOV_B06.p7, MARKOV_B06.p8,
)

# d0's CMA-ES fitted a-gate (out/d0/model-parameters.txt), the "Original"
# model of table 1 and figures 1-3.
HH_D0_FIT = _hh(
    5.694588454735844622e-05, 1.172955815858964107e-01,
    3.522672347205991382e-05, 4.972513487995382231e-02,
    MARKOV_B06.p5, MARKOV_B06.p6, MARKOV_B06.p7, MARKOV_B06.p8,
)

# d-study pretrain surface: the Markov a1/b1 rates as HH p1-p4
# (train-d1.py:821-823).
HH_D_PRETRAIN = _hh(
    MARKOV_B06.p1, MARKOV_B06.p2, MARKOV_B06.p3, MARKOV_B06.p4,
    MARKOV_B06.p5, MARKOV_B06.p6, MARKOV_B06.p7, MARKOV_B06.p8,
)

# Synthetic studies: g=1, E=-86 mV.
SYNTHETIC = Constants(np.float32(1.0), np.float32(-86.0))

# d-study tables: g=1, E=-88.4 mV.
TABLE1 = Constants(np.float32(1.0), np.float32(-88.4))

VRANGE = 100.0     # NN input voltage scale
NETSCALE = 1000.0  # NN output scale


# Real cell-5 r-gate, already in ms^-1 (train-r1.py:171-174); a-gate initial
# guess p1-p4 as used for pretraining (train-r1.py:849-852).
CELL5_RGATE = (
    np.float32(8.73243709432939552e-02),
    np.float32(7.33380025549188515e-03),
    np.float32(6.16551007196145754e-03),
    np.float32(3.15741310933875322e-02),
)
HH_CELL5_INIT = _hh(1.13e-4, 7.45e-2, 3.60e-5, 4.49e-2, *CELL5_RGATE)

# Full cell-5 HH fit (FourWaysOfFitting method 3): the r2 NN-d analytic base
# (train-r2.py:167-174).
HH_CELL5_FIT = _hh(
    2.10551451120238317e-04, 6.57994674459572992e-02,
    3.31717454417642909e-06, 7.43102564328181336e-02, *CELL5_RGATE,
)

# r1-bad uses rounded r-gate values and its own conductance
# (train-r1-bad.py:45, 138-141).
R1BAD_RGATE = (np.float32(8.73e-2), np.float32(8.90e-3),
               np.float32(5.20e-3), np.float32(3.16e-2))
HH_R1BAD_INIT = _hh(1.13e-4, 7.45e-2, 3.60e-5, 4.49e-2, *R1BAD_RGATE)

# Architecture sweep grid (architectures/s00.py..s11.py): id -> (n_layers,
# n_nodes) in the Linear(2,n)+n_layers*Linear(n,n)+Linear(n,1) convention.
ARCHITECTURES = {
    "s00": (5, 200), "s01": (1, 200), "s02": (10, 200),
    "s03": (5, 10), "s04": (1, 10), "s05": (10, 10),
    "s06": (5, 500), "s07": (1, 500), "s08": (10, 500),
    "s09": (5, 100), "s10": (1, 100), "s11": (10, 100),
}

# r0-bad CMA-ES fitted a-gate (r0-bad/model-parameters.txt).
HH_R0BAD_FIT = _hh(
    1.9074e-04, 4.8845e-02, 1.3319e-05, 6.2207e-02, *CELL5_RGATE,
)

# Real cell-5: g from FourWaysOfFitting, E = -88.4 mV (train-r1.py:42-45).
CELL5_RAW = Constants(np.float32(0.133898199260611944), np.float32(-88.4))

# r1 fudged constants: g*=1.2, E-=5 (train-r1.py:46-47).
CELL5_R1 = Constants(CELL5_RAW.g * 1.2, CELL5_RAW.e - 5.0)

# r2 keeps g*1.2 but not the E shift (r1-vs-r2 diff; table-2.py:32-37).
CELL5_R2 = Constants(CELL5_RAW.g * 1.2, CELL5_RAW.e)

# r1-bad conductance (train-r1-bad.py diff: g=0.1524).
CELL5_R1BAD = Constants(np.float32(0.1524), CELL5_RAW.e - 5.0)
