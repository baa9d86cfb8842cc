"""Voltage-clamp protocols (counterpart of ``ionflux/protocols.py``).

A protocol is a uniformly sampled voltage series; V(t) is a linear
interpolation between knots with a -80 mV fallback outside the sampled
domain (the reference's ``interp1d`` ValueError branch).  The fused solve
kernels use their own clamped lookup with no fallback
(``ops/fused_solve.py``).  The builders reproduce the reference templates
exactly and return tensors on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ionflux_torch._device import resolve_device

HOLDING_MV = -80.0  # out-of-domain fallback voltage


class Protocol(NamedTuple):
    """A voltage protocol on a uniform time grid (ms, mV)."""

    t0: torch.Tensor  # scalar, ms
    dt: torch.Tensor  # scalar, ms
    v: torch.Tensor   # [N] knot voltages, mV

    @property
    def n(self) -> int:
        return self.v.shape[-1]

    @property
    def duration(self) -> torch.Tensor:
        return self.t0 + (self.v.shape[-1] - 1) * self.dt

    def times(self) -> torch.Tensor:
        return self.t0 + self.dt * torch.arange(
            self.v.shape[-1], dtype=self.v.dtype, device=self.v.device)


def voltage(p: Protocol, t: torch.Tensor) -> torch.Tensor:
    """V(t) by linear interpolation, -80 mV out of domain.  ``t`` may have
    any shape; ``p`` is a single (unstacked) protocol.  No host read, so a
    solve's step block can be captured as a CUDA graph."""
    x = (t - p.t0) / p.dt
    n = p.v.shape[-1]
    i = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
    w = x - i.to(x.dtype)
    # take, not p.v[i]: a 0-d index tensor would be read on the host
    lo = torch.take(p.v, i)
    hi = torch.take(p.v, i + 1)
    val = lo + w * (hi - lo)
    in_dom = (x >= 0.0) & (x <= float(n - 1))
    return torch.where(in_dom, val, torch.full_like(val, HOLDING_MV))


def _make(v: np.ndarray, dt_ms: float, device) -> Protocol:
    device = resolve_device(device)
    return Protocol(torch.tensor(0.0, dtype=torch.float32, device=device),
                    torch.tensor(dt_ms, dtype=torch.float32, device=device),
                    torch.as_tensor(np.asarray(v, np.float32), device=device))


def from_time_series(t: np.ndarray, v: np.ndarray, dtype=torch.float32,
                     device=None) -> Protocol:
    """A Protocol from a time series that must lie on a uniform grid (all
    the study's protocols do)."""
    device = resolve_device(device)
    t = np.asarray(t, dtype=np.float64)
    dts = np.diff(t)
    dt = float(np.median(dts))
    if not np.allclose(dts, dt, rtol=1e-6, atol=1e-9):
        raise ValueError("protocol time grid is not uniform")
    return Protocol(torch.tensor(t[0], dtype=dtype, device=device),
                    torch.tensor(dt, dtype=dtype, device=device),
                    torch.as_tensor(np.asarray(v), device=device).to(dtype))


def load_csv(path: str, time_in_seconds: bool = True, dtype=torch.float32,
             device=None) -> Protocol:
    """A protocol from a ``time,voltage`` CSV with a header row, time in s
    (made ms) unless ``time_in_seconds`` is False."""
    raw = np.loadtxt(path, skiprows=1, delimiter=",")
    t = raw[:, 0] * (1e3 if time_in_seconds else 1.0)
    return from_time_series(t, raw[:, 1], dtype=dtype, device=device)


ACTIVATION_STEPS_MV = (-60.0, -40.0, -20.0, 0.0, 20.0, 40.0, 60.0)
DEACTIVATION_STEPS_MV = (
    -120.0, -110.0, -100.0, -90.0, -80.0, -70.0, -60.0, -50.0, -40.0,
)
ATAU_DURATIONS_01MS = (30, 100, 300, 1000, 3000, 10000)  # in 0.1 ms samples
ATAU_DURATIONS_MS = (3, 10, 30, 100, 300, 1000)  # 1 ms prediction variant


def _steps_to_values(n: int, segments) -> np.ndarray:
    v = np.zeros(n)
    for lo, hi, val in segments:
        v[lo:hi] = val
    return v


def activation_protocol(v_step: float, dt_ms: float = 0.1,
                        device=None) -> Protocol:
    """Pr3-like activation template, 8 s."""
    s = int(round(1.0 / dt_ms))
    n = 8000 * s + 1
    v = _steps_to_values(n, [
        (0, 1000 * s, -80.0),
        (1000 * s, 6000 * s, float(v_step)),
        (6000 * s, 7000 * s, -40.0),
        (7000 * s, 7500 * s, -120.0),
        (7500 * s, n, -80.0),
    ])
    return _make(v, dt_ms, device)


def deactivation_protocol(v_step: float, dt_ms: float = 0.1,
                          device=None) -> Protocol:
    """Pr5-like deactivation template, 10 s."""
    s = int(round(1.0 / dt_ms))
    n = 10000 * s + 1
    v = _steps_to_values(n, [
        (0, 1000 * s, -80.0),
        (1000 * s, 3000 * s, 50.0),
        (3000 * s, 9000 * s, float(v_step)),
        (9000 * s, 9500 * s, -120.0),
        (9500 * s, n, -80.0),
    ])
    return _make(v, dt_ms, device)


def atau_protocol(t_step_ms: float, dt_ms: float = 0.1,
                  device=None) -> Protocol:
    """Activation-time-constant-at-40mV template, 5 s."""
    s = int(round(1.0 / dt_ms))
    n = 5000 * s + 1
    ti = int(round(t_step_ms * s))
    v = _steps_to_values(n, [
        (0, 1000 * s, -80.0),
        (1000 * s, 1000 * s + ti, 40.0),
        (1000 * s + ti, 3500 * s + ti, -120.0),
        (3500 * s + ti, n, -80.0),
    ])
    return _make(v, dt_ms, device)


def activation_family(dt_ms: float = 0.1, device=None) -> list[Protocol]:
    return [activation_protocol(v, dt_ms, device) for v in ACTIVATION_STEPS_MV]


def deactivation_family(dt_ms: float = 0.1, device=None) -> list[Protocol]:
    return [deactivation_protocol(v, dt_ms, device)
            for v in DEACTIVATION_STEPS_MV]


def atau_family(dt_ms: float = 0.1, device=None) -> list[Protocol]:
    durs = (ATAU_DURATIONS_MS if dt_ms >= 1.0
            else [d * 0.1 for d in ATAU_DURATIONS_01MS])
    return [atau_protocol(d, dt_ms, device) for d in durs]


# The staircase main section: 19 x 500 ms steps.
STAIRCASE_STEPS_MV = [-40, -60, -20, -40, 0, -20, 20, 0, 40, 20,
                      40, 0, 20, -20, 0, -40, -20, -60, -40]


def staircase_protocol(dt_ms: float = 0.1, device=None) -> Protocol:
    """The staircase-ramp protocol (Lei et al. 2019), reconstructed
    parametrically as in the reference package."""
    dt = dt_ms
    segs: list[tuple] = [(-80.0, 250.0), (-120.0, 50.0),
                         ("ramp", -120.0, -80.0, 400.0),
                         (-80.0, 200.0), (40.0, 1000.0), (-120.0, 500.0),
                         (-80.0, 1000.0)]
    segs += [(float(v), 500.0) for v in STAIRCASE_STEPS_MV]
    segs += [(-80.0, 1050.0), (40.0, 500.0),
             ("ramp", 40.0, -120.0, 50.0), (-120.0, 400.0), (-80.0, 600.0)]
    arr = []
    for s in segs:
        if s[0] == "ramp":
            _, v0, v1, dur = s
            n = int(round(dur / dt))
            arr.append(v0 + (v1 - v0) * (np.arange(n) + 0.5) / n)
        else:
            v, dur = s
            arr.append(np.full(int(round(dur / dt)), v))
    return _make(np.concatenate(arr), dt, device)


def concat(ps: Sequence[Protocol]) -> Protocol:
    """Same-dt protocols end to end on one time axis; duplicate boundary
    knots are dropped."""
    dt = float(ps[0].dt)
    vs = [ps[0].v]
    for p in ps[1:]:
        if abs(float(p.dt) - dt) > 1e-9:
            raise ValueError("concat requires equal dt")
        vs.append(p.v[1:])
    return Protocol(ps[0].t0, ps[0].dt, torch.cat(vs))


def stack(ps: Sequence[Protocol]) -> Protocol:
    """Same-length protocols as one batched Protocol: v [B, N]."""
    return Protocol(t0=torch.stack([p.t0 for p in ps]),
                    dt=torch.stack([p.dt for p in ps]),
                    v=torch.stack([p.v for p in ps]))


# ---------------------------------------------------------------------------
# Step-boundary and capacitance masks (numpy, host side)
# ---------------------------------------------------------------------------


def change_points(v: np.ndarray) -> np.ndarray:
    """True where a sample CONTINUES the previous voltage (the first sample
    counts as continuing)."""
    v = np.asarray(v)
    return np.append([True], v[1:] == v[:-1])


def segment_edges(t: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Times where the voltage changes, plus t[-1] + 1 as the final
    sentinel."""
    t, v = np.asarray(t), np.asarray(v)
    t_split = t[np.append([False], v[:-1] != v[1:])]
    return np.append(t_split, t[-1] + 1)


def derivative_mask(n: int, step_indices: Sequence[int], lo: int = 5,
                    hi: int = 50) -> np.ndarray:
    """False on samples [i - lo, i + hi) around each voltage step i, where
    derivative estimates are unreliable."""
    mask = np.ones(n, dtype=bool)
    for i in step_indices:
        mask[max(i - lo, 0): min(i + hi, n)] = False
    return mask


def s_study_masks() -> tuple[np.ndarray, np.ndarray]:
    """The (activation, deactivation) masks of the synthetic studies' 0.1 ms
    grids."""
    mask1 = derivative_mask(80001, [10000, 60000, 70000, 75000])
    mask2 = derivative_mask(100001, [10000, 30000, 90000, 95000])
    return mask1, mask2


def capacitance_mask(v: np.ndarray, n_points: int = 70,
                     extra_changes: np.ndarray | None = None) -> np.ndarray:
    """Drop ``n_points`` samples after each voltage step (capacitive
    spikes); ``extra_changes`` marks more samples as changing."""
    cc = change_points(v)
    if extra_changes is not None:
        cc = cc | extra_changes
    mask = np.copy(cc)
    for i in range(n_points):
        mask &= np.roll(cc, i + 1)
    return mask


def training_mask(v: np.ndarray, n_points: int = 70, extra_points: int = 20,
                  extra_changes: np.ndarray | None = None) -> np.ndarray:
    """The capacitance mask widened by ``extra_points`` on both sides of
    each step."""
    cc = change_points(v)
    if extra_changes is not None:
        cc = cc | extra_changes
    mask = capacitance_mask(v, n_points, extra_changes)
    for i in range(extra_points):
        mask &= np.roll(cc, i + n_points + 1)
        mask &= np.roll(cc, -i - 1)
    return mask
