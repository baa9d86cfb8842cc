"""Stand-in reference files for the r-study replay drivers (table 2, table
S1, figures 4-7 and the ``--oracle`` branches), in the reference's layout,
written with ``torch.save``.  Both packages read them: the port with
``torch.load``, the JAX package with its torch-free ``utils.ptload``.

Importable without JAX: ``chip_smoke.py`` writes the full-length files with
it, the parity tests short ones (after ``_r_study_standins.patch_short``).

- State dicts (keys ``net.<2i>.weight`` [out, in], ``net.<2i>.bias``, as
  the reference's ``nn.Sequential`` names them) of the committed models:
  ``r1/best-model-checkpoint-2.pt`` (a checkpoint, the dict under
  "state_dict"), ``r2/model-state-dict-2.pt``, ``r1-bad/``, ``d1/``,
  ``d2/model-state-dict.pt``.  So ``--oracle`` replays the committed
  weights, and equals the default mode where that reads the same model.
- Traces, float64: ``table-2/{yo,y1,y2}-{sinewave,aps}.pt`` and
  ``figure-5/y1-{sinewave,aps}.pt``, the cell-5 HH fit's current
  g a r (V - E) with each tag's (g, E) (CELL5_RAW, CELL5_R1, CELL5_R2),
  a and r propagated exactly at each sample's voltage, times 1.02; and
  ``table-s1/<arch>-y1-{sinewave,aps,pr4}.pt`` for every architecture, the
  y1 trace scaled by 1 + 0.01 k for the k-th.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ionflux_torch import protorec
from ionflux_torch.models.registry import (ARCHITECTURES, CELL5_R1,
                                           CELL5_R2, CELL5_RAW, HH_CELL5_FIT)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reference file -> (committed model under out/, key of the state dict)
STATE_DICTS = {
    "r1/best-model-checkpoint-2.pt": ("r1/best-model.npz", "state_dict"),
    "r2/model-state-dict-2.pt": ("r2/best-model.npz", None),
    "r1-bad/model-state-dict.pt": ("r1-bad/model.npz", None),
    "d1/model-state-dict.pt": ("d1/model.npz", None),
    "d2/model-state-dict.pt": ("d2/model.npz", None),
}
TAGS = {"yo": CELL5_RAW, "y1": CELL5_R1, "y2": CELL5_R2}
# an archived trace is another run's, not this solve: 2% off, so that an
# MAE against it is not round-off alone
TRACE_SCALE = 1.02


def state_dict(npz_path: str) -> dict:
    """The MLP of a committed model.npz (leaves W [in, out], b, ..., then
    8 HH scalars) as a reference state dict."""
    with np.load(npz_path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    net = leaves[:-8]
    sd = {}
    for i, (w, b) in enumerate(zip(net[0::2], net[1::2])):
        sd[f"net.{2 * i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(w, np.float32).T))
        sd[f"net.{2 * i}.bias"] = torch.from_numpy(np.asarray(b, np.float32))
    return sd


def hh_gates(v: np.ndarray, dt: float, p=HH_CELL5_FIT) -> tuple:
    """(a, r) of the HH model p at every sample of v, from (0, 1), each
    step from one sample to the next taken exactly at the first sample's
    voltage."""
    p = [float(x) for x in p]
    k1 = p[0] * np.exp(p[1] * v)
    k2 = p[2] * np.exp(-p[3] * v)
    k3 = p[4] * np.exp(p[5] * v)
    k4 = p[6] * np.exp(-p[7] * v)
    a_inf, ea = k1 / (k1 + k2), np.exp(-(k1 + k2) * dt)
    r_inf, er = k4 / (k3 + k4), np.exp(-(k3 + k4) * dt)
    a, r = np.empty(v.size), np.empty(v.size)
    ya, yr = 0.0, 1.0
    for k in range(v.size):
        a[k], r[k] = ya, yr
        ya = a_inf[k] + (ya - a_inf[k]) * ea[k]
        yr = r_inf[k] + (yr - r_inf[k]) * er[k]
    return a, r


def hh_currents(name: str) -> dict:
    """{tag: the HH fit's current on a recorded protocol with the tag's
    (g, E)}."""
    v, dt = protorec.load_voltage(name)
    v = np.asarray(v, np.float64)
    a, r = hh_gates(v, dt)
    return {tag: TRACE_SCALE * float(c.g) * a * r * (v - float(c.e))
            for tag, c in TAGS.items()}


def _save(path: str, x) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    torch.save(x, path)


def write_state_dicts(refdir: str, out_root: str | None = None) -> None:
    out_root = out_root or os.path.join(ROOT, "out")
    for rel, (model, key) in STATE_DICTS.items():
        sd = state_dict(os.path.join(out_root, model))
        _save(os.path.join(refdir, rel),
              {key: sd, "epoch": 0} if key else sd)


def write_traces(refdir: str) -> None:
    for n in ("sinewave", "aps", "pr4"):
        ys = hh_currents(f"{n}-cell5")
        if n != "pr4":
            for tag, y in ys.items():
                _save(os.path.join(refdir, "table-2", f"{tag}-{n}.pt"), y)
            _save(os.path.join(refdir, "figure-5", f"y1-{n}.pt"), ys["y1"])
        for k, arch in enumerate(ARCHITECTURES):
            _save(os.path.join(refdir, "table-s1", f"{arch}-y1-{n}.pt"),
                  ys["y1"] * (1.0 + 0.01 * k))


def write_replay_files(refdir: str, out_root: str | None = None) -> None:
    """Every stand-in file of the replay drivers under refdir."""
    write_state_dicts(refdir, out_root)
    write_traces(refdir)
