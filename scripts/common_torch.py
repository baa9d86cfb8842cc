"""The command line of the ionflux_torch scripts (``train_*_torch.py``,
``table_1_torch.py``, ``figure_*_torch.py``): the JAX scripts' flags
(``scripts/common.py``) with ``--device`` in place of ``--platform``.

- ``--method`` sets the solver method of every ``eval.simulate`` in the run
  (``eval.DEFAULT_METHOD``);
- ``--x64`` makes float64 torch's default dtype, as ``jax_enable_x64``
  makes it JAX's: host data turned into tensors without a dtype (the
  tables' MAEs, the drawn noise) is float64;
- ``--trace`` records a ``torch.profiler`` trace of the whole run into
  ``<outdir>/trace/`` (``trace.json``, Chrome's format), written when the
  run ends, with the program's own spans and counts of the run
  (``ionflux_torch.utils.timing``: the calls' phases, B1's trips, the
  builds and captures) appended on the profiler's clock under the process
  ``ionflux_torch``, so Perfetto or chrome://tracing shows them above the
  kernels (spans as slices, counts as instant events with their value);
- ``--pred`` replays a trained study (``studies.predict_study``) instead of
  training it, ``--debug`` draws its surface plot (matplotlib);
- the real-data drivers (``real=True``) add ``--smoothi`` (the exp-fit
  surface variant where the raw CSVs are present) and ``--info sNN`` (an
  architecture of the r1-tune sweep).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def study_parser(description: str,
                 real: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--method", type=str, default="dopri5",
                   choices=["dopri5", "adams", "vcabm", "rosenbrock"])
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="draw the surface plot (rates3d-000.png)")
    p.add_argument("--pred", action="store_true",
                   help="replay the trained model on the prediction "
                        "protocols instead of training")
    p.add_argument("--cached", action="store_true",
                   help="reuse <outdir>/surface.npz or the cached traces")
    if real:
        p.add_argument("--smoothi", action="store_true",
                       help="the exp-fit derivative surface (raw CSVs only)")
        p.add_argument("--info", type=str, default=None,
                       help="architecture id s00..s11 (r1-tune sweep)")
    p.add_argument("--iters", type=int, default=None,
                   help="override the main training iterations")
    p.add_argument("--outdir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    p.add_argument("--x64", action="store_true",
                   help="float64 as torch's default dtype")
    p.add_argument("--trace", action="store_true",
                   help="a torch.profiler trace of the whole run under "
                        "<outdir>/trace/")
    return p


def parse(parser: argparse.ArgumentParser, argv=None):
    """The parsed flags; --method becomes ``eval.DEFAULT_METHOD`` and --x64
    torch's default dtype, as the JAX scripts' ``setup`` does."""
    args = parser.parse_args(argv)
    if args.method != "dopri5":
        from ionflux_torch import eval as E

        E.DEFAULT_METHOD = args.method
        print(f"solver method: {args.method}")
    if args.x64:
        import torch

        torch.set_default_dtype(torch.float64)
    return args


def outdir(args, default: str) -> str:
    """--outdir, else out/<default>, created."""
    path = args.outdir or os.path.join(ROOT, "out", default)
    os.makedirs(path, exist_ok=True)
    return path


@contextlib.contextmanager
def traced(args, out: str):
    """With --trace, a ``torch.profiler`` trace (CPU, and CUDA where there
    is a card) of the block, exported to <out>/trace/trace.json when it
    ends, however it ends; without it, nothing."""
    if not args.trace:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(out, "trace")
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    print(f"profiler trace -> {trace_dir}")
    prof = profile(activities=acts)
    prof.start()
    since = time.time_ns()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        add_recorded(path, since)


def add_recorded(path: str, since_ns: int) -> int:
    """Append the recorder's spans and counts from ``since_ns`` on to the
    Chrome trace ``path`` that ``torch.profiler`` exported, on its clock
    (``ts`` in microseconds past the file's ``baseTimeNanoseconds``).  The
    file is patched at its end, not parsed.  Returns the events added."""
    from ionflux_torch.utils import timing

    with open(path, "rb") as fh:
        found = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', fh.read(4096))
    base = int(found.group(1)) if found else 0
    who = {"pid": "ionflux_torch", "tid": "spans"}
    events = [dict(ph="X", name=s.name, ts=(s.start_ns - base) / 1e3,
                   dur=(s.end_ns - s.start_ns) / 1e3, **who,
                   args=dict(s.attrs, id=s.id, parent=s.parent))
              for s in timing.spans() if s.start_ns >= since_ns]
    events += [dict(ph="i", s="t", name=c.name, ts=(c.ns - base) / 1e3,
                    **who, args=dict(c.attrs, value=c.value, span=c.span))
               for c in timing.counts() if c.ns >= since_ns]
    if not events:
        return 0
    with open(path, "r+b") as fh:
        size = fh.seek(0, os.SEEK_END)
        at = max(0, size - 65536)
        fh.seek(at)
        tail = fh.read()
        # the traceEvents list closes before the file's last key
        last_key = tail.rfind(b'"traceName"')
        end = tail.rfind(b"]", 0, last_key if last_key >= 0 else len(tail))
        if end < 0:
            raise ValueError(f"{path}: no traceEvents list to extend")
        sep = b"" if tail[:end].rstrip().endswith(b"[") else b","
        fh.seek(at + end)
        fh.write(sep + b",".join(json.dumps(e, default=str).encode()
                                  for e in events) + tail[end:])
    return len(events)


def study_main(spec, n_seeds: int, description: str, argv=None, metric=None,
               target_from: str | None = None):
    """The study drivers' main: parse the flags; with --pred replay
    <outdir>/model.npz through ``studies.predict_study`` and return its
    MAEs, else train by ``studies.run_study_validated(spec)`` into --outdir
    (default out/<name>-torch) and return the kept params.  metric: the
    checkpoint metric (default: the table-1 rollouts); target_from: the
    study whose <outdir>/../<name>/model.npz net prints its "Target Loss"
    where it exists."""
    args = parse(study_parser(description), argv)
    if args.adjoint:
        print("--adjoint ignored: study training never differentiates "
              "through a solve; scripts/train_neural_ode_torch.py runs the "
              "adjoint path")
    import torch

    from ionflux_torch import studies as S

    torch.backends.cuda.matmul.allow_tf32 = False
    out = outdir(args, f"{spec.name}-torch")
    with traced(args, out):
        if args.pred:
            return S.predict_study(
                spec, S.load_study_params(spec, out, args.device))
        target_net = None
        if target_from is not None:
            d = os.path.join(os.path.dirname(os.path.abspath(out)),
                             target_from)
            if os.path.exists(os.path.join(d, "model.npz")):
                target_net = S.load_study_params(
                    S.STUDIES[target_from], d, args.device).net
        return S.run_study_validated(
            spec, out, n_seeds=n_seeds, iters=args.iters, cached=args.cached,
            debug=args.debug, metric=metric, target_net=target_net,
            device=args.device)


def real_study_main(spec, description: str, argv=None):
    """The r-study drivers' main: parse the flags (``real=True``); with
    --pred replay <outdir>/best-model.npz through
    ``rstudies.predict_real_study`` and return its MAEs, else train by
    ``rstudies.run_real_study`` into --outdir (default out/<name>-torch)
    and return the kept params."""
    args = parse(study_parser(description, real=True), argv)
    import torch

    from ionflux_torch import rstudies as R

    torch.backends.cuda.matmul.allow_tf32 = False
    out = outdir(args, f"{spec.name}-torch")
    with traced(args, out):
        if args.pred:
            return R.predict_real_study(spec, out, device=args.device)
        return R.run_real_study(spec, out, iters=args.iters,
                                smoothi=args.smoothi, device=args.device)


def drawing(path: str) -> bool:
    """True where matplotlib is installed; else say that ``path`` is not
    drawn (the numbers are computed either way)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: {path} not drawn")
        return False
    return True


def r_measurements(names, device) -> dict:
    """The measured cell-5 currents {name: (t_local_ms, i)} that the
    r-study replay scores against, recovered from the reference's surface
    caches under ``IONFLUX_REFERENCE`` (``rstudies.refdir``): pr3 and pr5
    from r1/, pr4 from r1-bad/ (its Pr3 + Pr4 cache); only those named."""
    from ionflux_torch import rstudies as R
    from ionflux_torch.models.registry import (CELL5_R1, CELL5_R1BAD,
                                               HH_CELL5_INIT, HH_R1BAD_INIT)
    from ionflux_torch.realdata import recover_measurements

    ref = R.refdir()
    out = {}
    if {"pr3", "pr5"} & set(names):
        out.update(recover_measurements(f"{ref}/r1", CELL5_R1, HH_CELL5_INIT,
                                        device=device))
    if "pr4" in names:
        out["pr4"] = recover_measurements(
            f"{ref}/r1-bad", CELL5_R1BAD, HH_R1BAD_INIT,
            protocols=("pr3", "pr4"), n_points=30, device=device)["pr4"]
    return {n: out[n] for n in names}


def lattice(tl) -> "np.ndarray":
    """The sample indices of a recovered measurement's local times."""
    import numpy as np

    from ionflux_torch import protorec

    return np.round(np.asarray(tl) / protorec.DT_MS).astype(np.int64)


def real_sim(out: str | None, cached: bool, device):
    """sim(cache_name, kind, params, name, c) -> a model's current (numpy
    float64) on a recorded cell-5 protocol (``name``: pr3, ..., aps): the
    multi-sweep recordings by ``eval.simulate_long``, the others by
    ``solve_states_real`` and the gate current.  With ``out``, each trace
    is cached as <out>/<cache_name>.npz and ``cached`` reads it back."""
    import numpy as np
    import torch

    from ionflux_torch import protorec
    from ionflux_torch.eval import simulate_long, solve_states_real
    from ionflux_torch.observe import gate_current

    def sim(cache_name, kind, params, name, c):
        path = out and os.path.join(out, f"{cache_name}.npz")
        if cached and path and os.path.exists(path):
            with np.load(path) as z:
                return z["y"]
        rec = f"{name}-cell5"
        if rec in protorec.SWEEPS:
            y = simulate_long(kind, params, rec, c, device=device)
        else:
            v, _ = protorec.load_voltage(rec)
            y = gate_current(solve_states_real(kind, params, rec,
                                               device=device),
                             torch.as_tensor(v, device=device).to(
                                 torch.float32), c)
        y = y.double().cpu().numpy()
        if path:
            np.savez(path, y=y)
        return y

    return sim
