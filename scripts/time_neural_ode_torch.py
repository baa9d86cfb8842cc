#!/usr/bin/env python
"""Times one full-size Adam update of ``scripts/train_neural_ode_torch.py``
on the card, by each way the update can run, for the same net and data.

    python3 scripts/time_neural_ode_torch.py [--whole]

The net and data are the script's (``main(--protocol act --iters 1)``: the
pretrained 2-200x5-1 NN-f, 301 outputs to 3,000 ms).  One JSON line each:

- ``fused``: the script's RK4 update, the solve's forward pass and its
  vector-Jacobian product one kernel launch each (``ops/node_rk4.py``;
  first update seconds, then ms an update over 3 updates, CUDA events,
  and each kernel's ms over 3 launches);
- ``interval graphs``: the RK4 update with the size rule forced to 0, the
  interval's forward and vector-Jacobian product captured once and
  replayed 300 times each (capture seconds, then ms an update over 3
  updates);
- ``interval eager``: the same code with no graph (1 update, host clock);
- ``autograd eager``: backprop through ``odeint_rk4`` (each interval
  rematerialised by ``torch.utils.checkpoint``) and a capturable Adam step
  (1 update);
- ``whole update graph`` (with ``--whole``): that autograd update captured
  as one CUDA graph after it ran once eagerly (capture seconds, ms an
  update over 2 replays);
- ``adjoint``: the ``--adjoint`` update (ms over 2 updates after one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import train_neural_ode_torch as NO  # noqa: E402

from ionflux_torch.ops import node_rk4 as NR  # noqa: E402


def _ms(fn, reps: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_s(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _autograd_update(tr: NO.Trainer) -> torch.Tensor:
    loss = tr.loss()
    loss.backward()
    tr.opt.step()
    return loss.detach()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--whole", action="store_true",
                   help="also capture the whole autograd update as one "
                        "CUDA graph (a capture of minutes)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_neural_ode: needs a CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        run = NO.main(["--protocol", "act", "--iters", "1", "--outdir", tmp])
    dev = run.data.device
    proto = NO.load_protocol("act", dev)
    ts = torch.linspace(0.0, 3000.0, 301, device=dev)
    y0 = torch.tensor([0.0, 1.0], device=dev)

    def trainer(**kw):
        return NO.Trainer(run.init, proto, ts, y0, run.data, **kw)

    def emit(**row):
        print(json.dumps(row), flush=True)

    tr = trainer(adjoint=False)
    first = _host_s(tr.step)
    packed = tr.plan.pack(tr.flat)
    ys, starts = NR._fwd_cuda(tr.plan, proto, ts, y0, packed)
    g_ys = torch.ones_like(ys)
    emit(way="fused", cluster=tr.plan.csize, first_update_s=first,
         ms=_ms(tr.step, 3),
         fwd_ms=_ms(lambda: NR._fwd_cuda(tr.plan, proto, ts, y0, packed), 3),
         vjp_ms=_ms(lambda: NR._vjp_cuda(tr.plan, proto, ts, starts, g_ys,
                                         packed), 3))
    with mock.patch.object(NR, "node_cluster", lambda *_: 0):
        tr = trainer(adjoint=False)
    first = _host_s(tr.step)
    emit(way="interval graphs", capture_s=tr.capture_s,
         first_update_s=first, ms=_ms(tr.step, 3))
    tr = trainer(adjoint=False, graph=False)
    emit(way="interval eager", ms=1e3 * _host_s(tr.step))
    tr = trainer(adjoint=False, graph=False)
    side = torch.cuda.Stream()       # the capture's warm-up stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ms = 1e3 * _host_s(lambda: _autograd_update(tr))
    torch.cuda.current_stream().wait_stream(side)
    emit(way="autograd eager", ms=ms)
    if args.whole:
        tr.opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        t = time.perf_counter()
        with torch.cuda.graph(graph):
            _autograd_update(tr)
        emit(way="whole update graph", capture_s=time.perf_counter() - t,
             ms=_ms(graph.replay, 2))
    tr = trainer(adjoint=True)
    tr.step()
    emit(way="adjoint", ms=_ms(tr.step, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
