"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` named in ``SOURCES`` has a plain C interface.
At first use each is compiled by ``nvcc`` for ``sm_90a`` into a library of
its own in ``ionflux_torch/_build/`` (listed in ``.gitignore``), under a
name that carries the source's hash, so an edited source is rebuilt, and is
loaded with ``ctypes``.  ``build()`` compiles all missing libraries at once,
one ``nvcc`` process per source, started together.  Nothing here runs at
import time.  No ``--use_fast_math``: the kernels' controllers must follow
the plain versions' f32 arithmetic.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from ionflux_torch.utils.timing import count, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# library name -> source; fused_solve: the MLP trip kernel (sweep, popsweep,
# population) and the MLP while-loop sweep; hh_solve: the HH population trip
# kernel and the HH RK4 kernel; bias_probe: the Mosaic bias-broadcast probe;
# tridiag: the spline's Thomas solve (K1); sym_eig: the Jacobi
# eigendecomposition of the device-resident CMA-ES (K2); node_rk4: the
# neural-ODE trainer's RK4 solve and its vector-Jacobian product
SOURCES = {
    "fused_solve": os.path.join(_PKG, "csrc", "fused_solve.cu"),
    "hh_solve": os.path.join(_PKG, "csrc", "hh_solve.cu"),
    "bias_probe": os.path.join(_PKG, "csrc", "bias_probe.cu"),
    "tridiag": os.path.join(_PKG, "csrc", "tridiag.cu"),
    "sym_eig": os.path.join(_PKG, "csrc", "sym_eig.cu"),
    "node_rk4": os.path.join(_PKG, "csrc", "node_rk4.cu"),
}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names=None) -> dict[str, tuple[str, str]]:
    """Compile every named source (all of ``SOURCES`` by default) whose
    hashed library is missing, in parallel.  Returns {name: (path, compiler
    log)}; the log holds ptxas' register and shared-memory report when a
    build ran, else is empty.  A build that runs nvcc is an ``ops.build``
    span (``source``: the sources built) with an ``ops.builds`` count of 1
    for each source (``utils/timing.py``)."""
    names = list(SOURCES) if names is None else list(names)
    out = {name: (library_path(name), "") for name in names}
    missing = [name for name in names if not os.path.exists(out[name][0])]
    if missing:
        with span("ops.build", source=",".join(missing)):
            out.update(_compile(missing))
            for name in missing:
                count("ops.builds", 1, source=name)
    return out


def _compile(names) -> dict[str, tuple[str, str]]:
    """One nvcc process per named source, started together; {name: (path,
    compiler log)}."""
    out, running = {}, {}
    try:
        for name in names:
            path = library_path(name)
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            running[name] = (path, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (path, tmp, proc) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                                   f"({proc.returncode}):\n{log}")
            os.replace(tmp, path)  # atomic: a concurrent build never sees half
            out[name] = (path, log)
    finally:
        for _, tmp, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLOATS = ctypes.POINTER(ctypes.c_float)

# library name -> {function: argtypes}; every function returns a cudaError_t
_SIGNATURES = {
    "fused_solve": {
        "ionflux_trip_solve": [
            _PTR, _PTR, _PTR, _I64,             # vpad, y0, w, w_stride
            _PTR, _I64, _I32,                   # b, b_stride, bf16
            _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,  # rec_sc, rec_y, rec_k, n_out,
                                                # alive_out, partial
            ctypes.POINTER(ctypes.c_int), _I32,  # sizes, n_layers
            _I32, _I32, _I32, _I32, _I32, _I32,  # p, q, n_pad, rt, trips,
                                                # block
            _I32, _I32,                         # cull, has_base
            _FLOATS,                            # scalars
            _I32, ctypes.POINTER(ctypes.c_int), _I32,  # ring, its geometry,
                                                # stage bytes,
            _I32,                               # rows before the padding
            _I32, ctypes.POINTER(ctypes.c_int), _I32,  # cluster size, its
                                                # geometry, floats per rank
            _PTR,                               # stream
        ],
        "ionflux_while_solve": [
            _PTR, _PTR, _PTR,                   # vpad, w, b
            _PTR, _PTR, _PTR, _PTR, _PTR,       # rec_sc, rec_y, rec_k, n_out,
                                                # partial
            ctypes.POINTER(ctypes.c_int), _I32,  # sizes, n_layers
            _I32, _I32, _I32, _I32, _I32,       # q, n_pad, rt, max_rec,
                                                # max_steps
            _FLOATS,                            # scalars
            _I32, ctypes.POINTER(ctypes.c_int), _I32,  # cluster size, its
                                                # geometry, floats per rank
            _PTR,                               # stream
        ],
    },
    "hh_solve": {
        "ionflux_hh_trip_solve": [
            _PTR, _PTR, _PTR,                   # vpad, params, y0
            _PTR, _PTR, _PTR, _PTR, _PTR,       # rec_sc, rec_y, rec_k, n_out,
                                                # alive_out
            _I32, _I32, _I32, _I32,             # b, n_pad, trips, block
            _I32,                               # threads per lane
            _FLOATS,                            # scalars
            ctypes.POINTER(ctypes.c_int),       # the launch's layout (out)
            _PTR,                               # stream
        ],
        "ionflux_hh_rk4": [
            _PTR, _PTR, _PTR,                   # v, params, out
            _I32, _I32, _I32, _I32,             # b, n_knots, n_out, n_sub
            _FLOATS,                            # scalars
            ctypes.POINTER(ctypes.c_int),       # the launch's layout (out)
            _PTR,                               # stream
        ],
    },
    "bias_probe": {
        "ionflux_bias_probe": [
            _PTR, _PTR, _PTR,                   # w, b, out
            _I32, _I32, _I32, _I32, _I32,       # p, q, m, trips, fold
            _PTR,                               # stream
        ],
    },
    "tridiag": {
        "ionflux_thomas": [
            _PTR, _PTR, _PTR, _PTR,             # dl, d, du, b
            _PTR, _PTR, _PTR,                   # x, cp, dp
            _PTR, _PTR, _I32,                   # start, len, n_sys
            _PTR,                               # stream
        ],
    },
    "sym_eig": {
        "ionflux_sym_eig": [
            _PTR, _PTR, _PTR,                   # a, w, v
            _I32, _I32, _I32,                   # m, n, max_sweeps
            _PTR,                               # stream
        ],
    },
    "node_rk4": {
        "ionflux_node_rk4_fwd": [
            _PTR, _PTR, _PTR, _PTR, _I32,       # w, knots, t0, dt, n_knots
            _PTR, _I32, _PTR,                   # ts, n_t, y0
            _PTR, _PTR,                         # ys, ystart
            ctypes.POINTER(ctypes.c_int), _I32,  # sizes, n_layers
            _I32, ctypes.POINTER(ctypes.c_int), _I32,  # cluster size, its
                                                # geometry, floats per rank
            _I32, _FLOATS,                      # n_sub, scalars
            _PTR,                               # stream
        ],
        "ionflux_node_rk4_vjp": [
            _PTR, _PTR, _PTR, _PTR, _I32,       # w, knots, t0, dt, n_knots
            _PTR, _I32,                         # ts, n_t
            _PTR, _PTR, _PTR,                   # ystart, g_ys, grad
            ctypes.POINTER(ctypes.c_int), _I32,  # sizes, n_layers
            _I32, ctypes.POINTER(ctypes.c_int), _I32,  # cluster size, its
                                                # geometry, floats per rank
            _I32, _FLOATS,                      # n_sub, scalars
            _PTR,                               # stream
        ],
    },
}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of one source, with every function's C signature
    set."""
    path, log = build([name])[name]
    lib = ctypes.CDLL(path)
    lib.build_log = log
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ionflux_error_string.argtypes = [ctypes.c_int]
    lib.ionflux_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, fn: str, dev, *args) -> None:
    """Call the C entry point ``fn`` of library ``name`` with ``args`` and
    the device's current stream; raise if the launch was refused."""
    lib = load_library(name)
    entry = getattr(lib, fn)
    if len(args) + 1 != len(entry.argtypes):    # ctypes passes extras on
        raise TypeError(f"{fn} takes {len(entry.argtypes) - 1} arguments "
                        f"and the stream, got {len(args)}")
    with torch.cuda.device(dev):
        err = entry(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn}: kernel launch failed: "
            f"{lib.ionflux_error_string(err).decode()} (cudaError {err})")


# The launches of the CUDA graph being captured, by wrapper (None: none is)
_captured: dict | None = None


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel in ``wrapper.launches``:
    now, or, for a launch recorded into a CUDA graph by ``Graph``, at each
    replay of that graph.  A capture itself launches nothing."""
    if _captured is not None and torch.cuda.is_current_stream_capturing():
        _captured[wrapper] = _captured.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1


class Graph:
    """``fn(*inputs)`` captured once as a CUDA graph on ``inputs``' device
    (``torch.cuda.CUDAGraph``) and replayed: each ``replay()`` runs the
    captured kernels on what ``inputs`` hold then (copy new values into
    them first) and returns the output tensor(s) of the capture, which the
    next replay overwrites.  ``fn`` must make no host synchronisation and
    no host-to-device copy, and must have run eagerly once on the device
    before (kernels built, caches filled).  Each replay adds the launches it
    recorded to the wrappers' counts (``count_launch``); the capture is a
    ``graph.capture`` span (``utils/timing.py``).  ``generators``
    (CUDA ``torch.Generator``s that ``fn`` draws from) are registered with
    the graph, so each replay draws new numbers and advances them."""

    def __init__(self, fn, *inputs, generators=()):
        global _captured
        self.inputs = inputs
        self._graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self._graph.register_generator_state(gen)
        _captured = {}
        try:
            with span("graph.capture"), torch.cuda.graph(self._graph):
                self.output = fn(*inputs)
            self.launches = _captured
        finally:
            _captured = None

    def replay(self):
        self._graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return self.output

