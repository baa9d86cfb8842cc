#!/usr/bin/env python
"""The checkpoint-validation chain of chip_smoke.py's phase (p), segment by
segment, on the card: where its shared clock spends its trips.

    python3 scripts/probe_validation_chain_torch.py [--trips 8192]
        [--rtol 1e-6] [--atol 1e-8] [--members 64]

Runs ``ops.fused_solve.fused_nnf_popsweep_chained`` over the five table-1
recordings (segments of 103,224 samples) for the first ``--members`` of
(p)'s 64 d1 members (x (1 + 0.01 N(0, 1)), ``RandomState(0)``), each
segment's final state the next one's y0, and prints one JSON line: the
card, the settings, the seconds of the chain, and per segment its executed
trips (``n_valid``), its accepted steps (``n_acc``, negative when the
launch fell short of t_end: then every lane is inf and the later segments
start dead), the lanes alive after it, the last trip's start time (ms,
local to the segment) and its milliseconds.  Defaults:
studies.table_rollout_maes_pop's settings.  chip_smoke.py's (p) logs the
same per-segment figures through ``chain_segments``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def chain_segments(layers, rgate, seg_v: torch.Tensor, dt: float,
                   t_end: float, q: int, **kw) -> list[dict]:
    """Run ``fused_nnf_popsweep_chained`` over ``seg_v`` [B, Q_pad, L] with
    ``kw`` (trips, rtol, atol) and return, per segment, its executed trips,
    accepted steps (negative: t_end not reached), lanes alive among the
    first ``q`` rows, the last trip's start time (ms) and the milliseconds
    from the previous segment's end (CUDA events: its launch and final
    state).  One host synchronisation, at the end."""
    from ionflux_torch.ops import fused_solve as F

    stats, events = [], [torch.cuda.Event(enable_timing=True)]

    def consume(b, recs):
        last = torch.clamp(recs.n_valid - 1, min=0)
        stats.append(torch.stack([
            recs.n_valid.float(), recs.n_acc.float(),
            recs.mask[:, :q].sum().float(), recs.rec_sc[last, 0]]))
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    events[0].record()
    F.fused_nnf_popsweep_chained(layers, rgate, seg_v, proto_dt=dt,
                                 t_end=t_end, consume=consume, **kw)
    torch.cuda.synchronize()
    return [dict(n_valid=int(r[0]), n_acc=int(r[1]), alive=int(r[2]),
                 last_t_ms=r[3], ms=a.elapsed_time(b))
            for r, a, b in zip(torch.stack(stats).tolist(), events[:-1],
                               events[1:])]


def main(trips: int, rtol: float, atol: float, members: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_validation_chain_torch: no CUDA device")
    sys.path.insert(0, HERE)
    C = _chip_smoke()
    from ionflux_torch import eval as E
    from ionflux_torch.ops import _build
    from ionflux_torch.utils.ckpt import params_from_leaves

    _build.load_library("fused_solve")       # the build is not timed
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    leaves = C.npz_leaves(os.path.join(HERE, "out", "d1", "model.npz"))
    pop = params_from_leaves(C.population(leaves, C.P_POP, 0), "nnf", dev)
    layers = [(w[:members], b[:members]) for w, b in pop.net.layers]
    _, dt, seg, _, _, seg_v, _ = E._segment_recordings(
        C.VAL_NAMES, seg_samples=C.VAL_KW["seg_samples"],
        chunk=C.VAL_KW["chunk"])
    t = time.perf_counter()
    segments = chain_segments(
        layers, pop.rgate, torch.as_tensor(seg_v, device=dev), float(dt),
        seg * float(dt), len(C.VAL_NAMES), trips=trips, rtol=rtol,
        atol=atol)
    return dict(card=C.device_line(), trips=trips, rtol=rtol, atol=atol,
                members=members, lanes=members * len(C.VAL_NAMES),
                seconds=time.perf_counter() - t, t_end_ms=seg * float(dt),
                segments=segments)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trips", type=int, default=8192)
    ap.add_argument("--rtol", type=float, default=1e-6)
    ap.add_argument("--atol", type=float, default=1e-8)
    ap.add_argument("--members", type=int, default=64)
    args = ap.parse_args()
    print(json.dumps(main(args.trips, args.rtol, args.atol, args.members)),
          flush=True)
