"""The reference of checkpoint validation: every (member, recording) lane
solved on its whole recording from rest (a = 0, r = 1) by the plain
adaptive Dormand-Prince solver, each lane with its own clock, and the mean
absolute error of its current against the targets over the scored span."""

from __future__ import annotations

import contextlib

import torch

from .models import current, gate_rhs
from .ode import dopri5_lanes

H0_MS = 0.1
H_MAX_MS = 100.0
SAMPLE_BLOCK = 1 << 22      # dense-output points evaluated at once


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in TF32 (tf32=True) or in full float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def solve(kind: str, layers, p, voltages, dt: float, *, rtol: float,
          atol: float, dtype=torch.float64, tf32: bool = False) -> dict:
    """Solve P member nets (W [P, in, out], b [P, out]) on Q recordings
    ``voltages`` (list of [N_q] tensors at spacing dt ms), every (member,
    recording) lane from rest to its recording's end.  The states and
    products run in ``dtype`` (TF32 products with ``tf32``); the clock runs
    in float64.  Returns the solve: its Steps and the recordings."""
    dev = layers[0][0].device
    n_mem, n_rec = layers[0][0].shape[0], len(voltages)
    lens = [int(v.shape[0]) for v in voltages]
    n_max = max(lens)
    v_all = torch.empty((n_rec, n_max), dtype=torch.float64, device=dev)
    for q, v in enumerate(voltages):
        v_all[q, :lens[q]] = v.to(torch.float64)
        v_all[q, lens[q]:] = v[-1].to(torch.float64)
    v_flat = v_all.reshape(-1)
    lane_q = torch.arange(n_rec, device=dev).repeat(n_mem)     # [P Q]
    lane_len = torch.tensor(lens, device=dev)[lane_q]
    w_layers = [(w.to(dtype), b.to(dtype)) for w, b in layers]
    pp = [float(x) for x in p]

    def volt(t):
        x = (t / dt).clamp(min=0.0)
        x = torch.minimum(x, (lane_len - 1).to(torch.float64))
        i = torch.minimum(x.floor().to(torch.int64), lane_len - 2)
        w = x - i.to(torch.float64)
        base = lane_q * n_max + i
        lo, hi = v_flat[base], v_flat[base + 1]
        return lo + w * (hi - lo)

    def rhs(t, y):
        v = volt(t).to(dtype).reshape(n_mem, n_rec)
        return gate_rhs(kind, w_layers, pp, y.reshape(n_mem, n_rec, 2),
                        v).reshape(-1, 2)

    y0 = torch.zeros((n_mem * n_rec, 2), dtype=dtype, device=dev)
    y0[:, 1] = 1.0
    t_end = (lane_len - 1).to(torch.float64) * dt
    with matmul_precision(tf32):
        steps = dopri5_lanes(rhs, y0, t_end, rtol=rtol, atol=atol, h0=H0_MS,
                             h_max=H_MAX_MS)
    return {"steps": steps, "v_all": v_all, "dt": dt, "members": n_mem}


def score(sol: dict, targets, spans, g: float, e: float) -> torch.Tensor:
    """MAEs [P, Q] (float64) of a solve's currents against ``targets``
    (list of [N_q]), each scored on samples [lo, hi) of ``spans``."""
    steps, v_all, dt, n_mem = (sol["steps"], sol["v_all"], sol["dt"],
                               sol["members"])
    n_rec = v_all.shape[0]
    dev = v_all.device
    maes = torch.empty((n_mem, n_rec), dtype=torch.float64, device=dev)
    for q in range(n_rec):
        lanes = torch.arange(n_mem, device=dev) * n_rec + q
        lo, hi = spans[q]
        tgt = targets[q].to(torch.float64)
        total = torch.zeros(n_mem, dtype=torch.float64, device=dev)
        step = max(1, SAMPLE_BLOCK // n_mem)
        for s0 in range(lo, hi, step):
            s = torch.arange(s0, min(s0 + step, hi), device=dev)
            tau = (s.to(torch.float64) * dt)[None].expand(n_mem, -1)
            y = steps.at(lanes, tau.contiguous()).to(torch.float64)
            i = current(y, v_all[q][s][None], g, e)
            total += (i - tgt[s][None]).abs().sum(dim=1)
        maes[:, q] = total / (hi - lo)
    return maes
