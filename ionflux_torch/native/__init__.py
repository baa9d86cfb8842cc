"""ctypes bindings for the native C++ host solver (counterpart of
``ionflux/native``): adaptive dopri5 on the host with a wall-clock watchdog
and inf-trace failure sentinels, the rebuild of the reference's optional
Myokit/CVODE backend (the d0 fit's ``--myokit`` objective).

The port keeps its own copy of the source (``csolver.cpp`` here) and builds
it on first use with g++ and the reference package's flags into
``ionflux_torch/_build/`` (a library named by the source's hash), so both
packages compute the same numbers on one machine.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csolver.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libionflux_native_{digest}.so")


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            out = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed on {_SRC}:\n{out.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    sig = [dp, ctypes.c_double, ctypes.c_double, dp, ctypes.c_int64, dp, dp,
           ctypes.c_int64, dp, ctypes.c_double, ctypes.c_double,
           ctypes.c_int64, ctypes.c_double]
    for name in ("ionflux_solve_hh", "ionflux_solve_markov"):
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def csolve(kind: str, params, proto_t0: float, proto_dt: float,
           knots: np.ndarray, ts: np.ndarray, y0: np.ndarray | None = None,
           rtol: float = 1e-7, atol: float = 1e-9, max_steps: int = 10_000_000,
           timeout_s: float = 600.0):
    """Adaptive dopri5 solve on the host.  kind: 'hh' (8 params, 2 states)
    or 'markov' (12 params, 6 states).  Returns ys [T, S] float64 (inf rows
    on timeout or divergence)."""
    lib = _load()
    params = np.asarray(params, np.float64).reshape(-1)
    if kind == "hh":
        fn, s, n_p = lib.ionflux_solve_hh, 2, 8
        y0 = np.array([0.0, 1.0]) if y0 is None else y0
    elif kind == "markov":
        fn, s, n_p = lib.ionflux_solve_markov, 6, 12
        y0 = (np.array([0.0, 1.0, 0.0, 0.0, 0.0, 0.0]) if y0 is None else y0)
    else:
        raise ValueError(kind)
    if params.size != n_p:
        raise ValueError(f"{kind} expects {n_p} params, got {params.size}")
    knots, ts, y0 = (np.ascontiguousarray(a, dtype=np.float64)
                     for a in (knots, ts, y0))
    out = np.empty((len(ts), s), np.float64)
    fn(_ptr(params), float(proto_t0), float(proto_dt), _ptr(knots),
       len(knots), _ptr(y0), _ptr(ts), len(ts), _ptr(out), float(rtol),
       float(atol), int(max_steps), float(timeout_s))
    return out
