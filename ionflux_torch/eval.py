"""Forward simulation of gate models on protocols (counterpart of
``ionflux/eval.py``, the dopri5 and fused-kernel paths).

- ``simulate`` / ``simulate_family``: currents of one model on one protocol
  or a same-length family; ``backend="pallas"`` runs the fused sweep solve
  (``ops/fused_solve.fused_nnf_solve_ft``), the name kept so callers port
  unchanged.  ``simulate_cases`` runs many (protocol, times) cases.
- ``solve_states_long`` / ``simulate_long`` / ``solve_states_real``: one
  model on a recorded protocol, the multi-sweep ones chained per sweep on
  local f32 clocks (``solver/chained.odeint_chained``).
- ``simulate_population``: P member nets x Q protocols through the fused
  popsweep solve; ``simulate_population_real`` and
  ``population_rollout_maes`` do it on the recorded protocols, chained over
  segments (``ops/fused_solve.fused_nnf_popsweep_chained``): the
  checkpoint-validation workload.  On the card the rollout MAEs' chain is
  one CUDA graph.  ``simulate_population_sharded`` shards the members over
  a mesh of processes (``parallel``), one popsweep launch a rank.

Everything follows the device of the tensors it is given; where no
argument carries a tensor, ``device`` says where to run (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch import protorec
from ionflux_torch._device import resolve_device
from ionflux_torch.models import (
    MARKOV_Y0_REST,
    gt_a_rhs,
    hh_rhs,
    markov_rhs,
    nnd_rhs,
    nnf_rhs,
)
from ionflux_torch.models.registry import Constants
from ionflux_torch.observe import gate_current, mae, markov_current
from ionflux_torch.ops._build import Graph
from ionflux_torch.ops.fused_solve import (
    POPSWEEP_SPLIT_ROWS,
    SWEEP_MAX_ROWS,
    _dense_eval_popsweep_ft,
    _rest,
    _time_on,
    _trip_solve_cuda,
    fused_nnf_popsweep_chained,
    fused_nnf_popsweep_solve_ft,
    fused_nnf_solve_ft,
    popsweep_plan,
    weight_stream_bytes,
)
from ionflux_torch.solver import (odeint, odeint_adams, odeint_chained,
                                  odeint_rosenbrock, odeint_vcabm)
from ionflux_torch.utils.timing import count, span

_RHS = {"hh": hh_rhs, "markov": markov_rhs, "nnf": nnf_rhs, "nnd": nnd_rhs,
        "gta": gt_a_rhs}


def _model_rhs(kind: str):
    if kind not in _RHS:
        raise ValueError(f"model kind {kind!r} is not ported; have "
                         f"{sorted(_RHS)}")
    core = _RHS[kind]

    def rhs(t, y, args):
        params, proto = args
        return core(params, t, y, P.voltage(proto, t))

    return rhs


def default_y0(kind: str, dtype=torch.float32, device=None) -> torch.Tensor:
    """Rest state after holding at -80 mV: (a, r) = (0, 1), or the Markov
    model's ``MARKOV_Y0_REST`` (all in c2)."""
    if kind not in _RHS:
        raise ValueError(f"model kind {kind!r} is not ported")
    if kind == "markov":
        return torch.tensor(MARKOV_Y0_REST, dtype=dtype, device=device)
    return torch.tensor([0.0, 1.0], dtype=dtype, device=device)


def _observe(kind: str, ys: torch.Tensor, v: torch.Tensor,
             c: Constants) -> torch.Tensor:
    """The observed current of states ys at voltages v."""
    if kind == "markov":
        return markov_current(ys, v, c)
    return gate_current(ys, v, c)


def _solve_device(params, y0, device) -> torch.device:
    """Where a solve from a recording runs: ``device`` if given, else the
    device of y0 or of an MLP's weights, else the card
    (``resolve_device``; the HH and Markov parameters are host scalars)."""
    if device is not None:
        return torch.device(device)
    if isinstance(y0, torch.Tensor):
        return y0.device
    net = getattr(params, "net", None)
    return net.layers[0][0].device if net is not None else resolve_device(
        None)


# The process-wide default solver method; the scripts' --method flag sets
# it (scripts/common_torch.py).
DEFAULT_METHOD = "dopri5"


def solve_states(kind: str, params, proto: P.Protocol, ts: torch.Tensor,
                 y0=None, rtol=1e-6, atol=1e-8, method: str | None = None,
                 **kw) -> torch.Tensor:
    """States [T, S] of one model on one protocol, by ``method``
    (``DEFAULT_METHOD`` when None)."""
    if method is None:
        method = DEFAULT_METHOD
    if y0 is None:
        y0 = default_y0(kind, ts.dtype, ts.device)
    solver = {"adams": odeint_adams, "vcabm": odeint_vcabm,
              "rosenbrock": odeint_rosenbrock}.get(method, odeint)
    return solver(_model_rhs(kind), y0, ts, (params, proto), rtol=rtol,
                  atol=atol, **kw)


def simulate(kind: str, params, proto: P.Protocol, ts: torch.Tensor,
             c: Constants, y0=None, rtol=1e-6, atol=1e-8,
             method: str | None = None, **kw) -> torch.Tensor:
    """Observed current [T] of one model on one protocol (method: 'dopri5'
    | 'adams' (ABM4) | 'vcabm' (variable order 1-12) | 'rosenbrock'
    (implicit L-stable 2(3), stiff systems); ``DEFAULT_METHOD`` when
    None)."""
    ys = solve_states(kind, params, proto, ts, y0, rtol, atol, method, **kw)
    return _observe(kind, ys, P.voltage(proto, ts), c)


def _family_voltage(b: P.Protocol, ts) -> torch.Tensor:
    """V(ts) [B, T] of every row of a stacked protocol."""
    return torch.stack([P.voltage(P.Protocol(t0, dt, v), ts)
                        for t0, dt, v in zip(b.t0, b.dt, b.v)])


def simulate_family(kind: str, params, protos: list[P.Protocol],
                    ts: torch.Tensor, c: Constants, backend: str = "xla",
                    **kw) -> torch.Tensor:
    """Currents [B, T] over a same-length protocol family.

    backend="xla": one dopri5 solve per protocol (``simulate``'s keywords).
    backend="pallas" (NN-f/NN-d): the fused sweep solve, one shared
    controller per launch of <= 128 protocols (larger families split in
    halves); a diverging protocol row returns inf for its row only, a trips
    shortfall infs its whole launch.  Keywords: rtol (1e-6), atol (1e-8),
    trips (4096)."""
    if backend == "pallas":
        if kind not in ("nnf", "nnd"):
            raise ValueError("backend='pallas' supports the MLP families "
                             "(nnf/nnd) only")
        if len(protos) > SWEEP_MAX_ROWS:
            half = (len(protos) + 1) // 2
            return torch.cat([
                simulate_family(kind, params, protos[:half], ts, c,
                                backend=backend, **kw),
                simulate_family(kind, params, protos[half:], ts, c,
                                backend=backend, **kw)], dim=0)
        b = P.stack(protos)
        ys = fused_nnf_solve_ft(
            params.net, params.rgate if kind == "nnf" else params.hh, b.v, ts,
            proto_t0=float(protos[0].t0), proto_dt=float(protos[0].dt),
            t_end=float(ts[-1]), rtol=kw.get("rtol", 1e-6),
            atol=kw.get("atol", 1e-8), trips=kw.get("trips", 4096),
            base_hh=params.hh if kind == "nnd" else None)
        return gate_current(ys, _family_voltage(b, ts), c)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    return torch.stack([simulate(kind, params, pr, ts, c, **kw)
                        for pr in protos])


def _pop_shared(hh):
    """Gate scalars shared by all members: member 0's values where a
    population carries them with a leading axis."""
    return type(hh)(*[x.reshape(-1)[0] if getattr(x, "ndim", 0) > 0 else x
                      for x in hh])


def _pop_split(kind: str, pop_params):
    """(nets, rgate_or_base, base_hh) of a population NNfParams/NNdParams."""
    if kind not in ("nnf", "nnd"):
        raise ValueError("population paths support the MLP families "
                         "(nnf/nnd) only")
    hh = None if kind == "nnf" else _pop_shared(pop_params.hh)
    rg = _pop_shared(pop_params.rgate) if kind == "nnf" else hh
    return pop_params.net.layers, rg, hh


def simulate_population(kind: str, pop_params, protos: list[P.Protocol],
                        ts: torch.Tensor, c: Constants,
                        **kw) -> torch.Tensor:
    """Currents [P, Q, T] of a POPULATION of nets (net leaves with a leading
    member axis) over a protocol family, through the fused popsweep solve.
    Families larger than POPSWEEP_SPLIT_ROWS run as launches of that many
    rows.  Keywords: rtol (1e-5), atol (1e-7), trips (4096), cull (True),
    mxu_bf16 (False)."""
    if len(protos) > POPSWEEP_SPLIT_ROWS:
        return torch.cat(
            [simulate_population(kind, pop_params,
                                 protos[i:i + POPSWEEP_SPLIT_ROWS], ts, c,
                                 **kw)
             for i in range(0, len(protos), POPSWEEP_SPLIT_ROWS)], dim=1)
    b = P.stack(protos)
    nets, rg, hh = _pop_split(kind, pop_params)
    return _population_currents(nets, rg, hh, b, ts, c,
                                t0f=float(protos[0].t0),
                                dtf=float(protos[0].dt),
                                t_endf=float(ts[-1]), **kw)


def _population_currents(nets, rg, hh, b: P.Protocol, ts, c: Constants, *,
                         t0f: float, dtf: float,
                         t_endf: float, **kw) -> torch.Tensor:
    """One popsweep launch: P member nets x the stacked protocols b ->
    currents [P, Q, T]."""
    ys = fused_nnf_popsweep_solve_ft(
        nets, rg, b.v, ts, proto_t0=t0f, proto_dt=dtf, t_end=t_endf,
        rtol=kw.get("rtol", 1e-5), atol=kw.get("atol", 1e-7),
        trips=kw.get("trips", 4096), base_hh=hh, cull=kw.get("cull", True),
        mxu_bf16=kw.get("mxu_bf16", False))                  # [P, Q, T, 2]
    return gate_current(ys, _family_voltage(b, ts)[None], c)


def simulate_population_sharded(kind: str, pop_params,
                                protos: list[P.Protocol], ts: torch.Tensor,
                                c: Constants, mesh=None, axis: str = "pop",
                                **kw) -> torch.Tensor:
    """``simulate_population`` with the member axis sharded over a mesh of
    processes (``parallel.make_mesh``): each rank runs its own popsweep
    launch on its member shard, no collective enters the solve, and the
    currents [P, Q, T] are gathered on every rank.  P must divide evenly
    over the axis.  Every rank passes the whole population; mesh=None is
    the mesh of this process alone."""
    from ionflux_torch.parallel.mesh import make_mesh, sharded_map

    if len(protos) > POPSWEEP_SPLIT_ROWS:
        return torch.cat(
            [simulate_population_sharded(kind, pop_params,
                                         protos[i:i + POPSWEEP_SPLIT_ROWS],
                                         ts, c, mesh=mesh, axis=axis, **kw)
             for i in range(0, len(protos), POPSWEEP_SPLIT_ROWS)], dim=1)
    nets, rg, hh = _pop_split(kind, pop_params)
    if mesh is None:
        mesh = make_mesh(axes=(axis,), device=nets[0][0].device)
    n_dev = mesh.shape[axis]
    p_mem = nets[0][0].shape[0]
    if p_mem % n_dev:
        raise ValueError(f"population {p_mem} does not divide over the "
                         f"{n_dev}-rank '{axis}' mesh axis")
    b = P.Protocol(*(x.to(mesh.device) for x in P.stack(protos)))
    ts = ts.to(mesh.device)
    t0f, dtf, t_endf = float(protos[0].t0), float(protos[0].dt), float(
        ts[-1])

    def local(nets_shard):
        return _population_currents(nets_shard, rg, hh, b, ts, c, t0f=t0f,
                                    dtf=dtf, t_endf=t_endf, **kw)

    return sharded_map(mesh, axis, local)(nets)


# ---------------------------------------------------------------------------
# One model on the recorded protocols
# ---------------------------------------------------------------------------


def pad_protocol(proto: P.Protocol, n_knots: int) -> P.Protocol:
    """Extend a protocol to n_knots by repeating its final value.  The padded
    knots lie past every query time, so results are unchanged."""
    cur = proto.v.shape[-1]
    if cur >= n_knots:
        return proto
    pad = proto.v[-1:].expand(n_knots - cur)
    return P.Protocol(proto.t0, proto.dt, torch.cat([proto.v, pad]))


def simulate_cases(kind: str, params, cases, c: Constants, **kw):
    """Currents of many (protocol, ts) cases, each padded to the largest
    knot count and output grid (repeating t_end) and sliced back, as the
    reference does to share one compiled solve."""
    n_knots = max(case[0].v.shape[-1] for case in cases)
    n_ts = max(case[1].shape[-1] for case in cases)
    out = []
    for proto, ts in cases:
        t_len = ts.shape[-1]
        ts_pad = torch.cat([ts, ts[-1:].expand(n_ts - t_len)])
        i = simulate(kind, params, pad_protocol(proto, n_knots), ts_pad, c,
                     **kw)
        out.append(i[:t_len])
    return out


def solve_states_long(kind: str, params, name: str, y0=None, rtol=1e-6,
                      atol=1e-8, max_steps: int = 200_000,
                      buffer_size: int = 16384, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """States [N, S] at every sample of a multi-sweep recording
    (``protorec.SWEEPS``) by the segment-chained solve: one local f32 clock
    per sweep, the state carried across sweeps.  A single f32 clock over
    these 46-93 s recordings stalls (ulp(93,000 ms) ~ 0.008 ms).  Each
    sweep's segment overlaps the next sweep's first sample, so it
    integrates through the 0.1 ms ramp into it."""
    n_sweeps, period = protorec.SWEEPS[name]
    v, dt = protorec.load_voltage(name)
    if len(v) != n_sweeps * period:
        raise ValueError(f"{name}: {len(v)} samples, expected "
                         f"{n_sweeps} x {period}")
    vs = np.empty((n_sweeps, period + 1), v.dtype)
    vs[:, :period] = v.reshape(n_sweeps, period)
    vs[:-1, period] = vs[1:, 0]
    vs[-1, period] = vs[-1, period - 1]
    dev = _solve_device(params, y0, device)
    protos = P.Protocol(
        torch.zeros(n_sweeps, dtype=dtype, device=dev),
        torch.full((n_sweeps,), dt, dtype=dtype, device=dev),
        torch.as_tensor(vs, device=dev).to(dtype))
    ts = (torch.arange(period + 1, dtype=dtype, device=dev)
          * torch.tensor(dt, dtype=dtype, device=dev))
    if y0 is None:
        y0 = default_y0(kind, dtype, dev)
    ys = odeint_chained(_model_rhs(kind), y0, ts, protos, params, rtol=rtol,
                        atol=atol, max_steps=max_steps,
                        buffer_size=buffer_size)         # [B, T + 1, S]
    return ys[:, :-1, :].reshape(n_sweeps * period, -1)  # drop the overlap


def simulate_long(kind: str, params, name: str, c: Constants, y0=None,
                  dtype=torch.float32, device=None, **kw) -> torch.Tensor:
    """Current [N] on a multi-sweep recording (see solve_states_long)."""
    ys = solve_states_long(kind, params, name, y0, dtype=dtype,
                           device=device, **kw)
    v, _ = protorec.load_voltage(name)
    vq = torch.as_tensor(v.reshape(-1), device=ys.device).to(dtype)
    return _observe(kind, ys, vq, c)


def solve_states_real(kind: str, params, name: str, y0=None,
                      dtype=torch.float32, device=None, **kw) -> torch.Tensor:
    """States on any recorded protocol: the multi-sweep ones through
    ``solve_states_long``, single-segment ones (sinewave, APs) by one
    adaptive solve on their full 0.1 ms grid (max_steps 400,000 and
    buffer_size 32,768 unless given)."""
    if name in protorec.SWEEPS:
        return solve_states_long(kind, params, name, y0, dtype=dtype,
                                 device=device, **kw)
    dev = _solve_device(params, y0, device)
    v, dt = protorec.load_voltage(name)
    proto = protorec.protocol(name, dtype=dtype, device=dev)
    ts = torch.as_tensor(np.arange(len(v)) * dt, device=dev).to(dtype)
    kw.setdefault("max_steps", 400_000)
    kw.setdefault("buffer_size", 32768)
    return solve_states(kind, params, proto, ts, y0=y0, **kw)


def report_mae(name: str, pred: torch.Tensor, truth: torch.Tensor,
               fmt: str = "{name} | Total Loss {loss:.6f}") -> float:
    """Print the reference's per-protocol loss line and return the MAE."""
    loss = float(mae(torch.as_tensor(pred), torch.as_tensor(truth)))
    print(fmt.format(name=name, loss=loss))
    return loss


# ---------------------------------------------------------------------------
# A population of nets on the recorded protocols (checkpoint validation)
# ---------------------------------------------------------------------------


def _segment_recordings(names: list[str], *, seg_samples: int, chunk: int,
                        voltages: dict | None = None):
    """The host-side segmentation both population paths share: the named
    recordings (equal rate; ``voltages`` {name: (v, dt_ms)} stands in for
    them) padded at their final value into knot segments seg_v [B, Q,
    seg + 1], and each segment's sample voltages vsegs [B, Q, n_ch chunk],
    edge-padded to whole chunks.  Returns (lens, dt, seg, n_seg, n_ch,
    seg_v, vsegs)."""
    vs, lens = [], []
    dt = None
    for n in names:
        v, dti = (voltages[n] if voltages is not None
                  else protorec.load_voltage(n))
        if dt is not None and dti != dt:
            raise ValueError(
                f"mixed sample rates: {n} has dt={dti} ms but earlier "
                f"protocols have dt={dt} ms; all Q rows share one clock")
        dt = dti
        vs.append(np.asarray(v, np.float32))
        lens.append(len(v))
    max_len = max(lens)
    seg = min(int(seg_samples), max_len)
    n_seg = -(-max_len // seg)
    padded = np.empty((len(names), n_seg * seg + 1), np.float32)
    for i, v in enumerate(vs):
        padded[i, :lens[i]] = v
        padded[i, lens[i]:] = v[-1]
    seg_v = np.stack([padded[:, b * seg:b * seg + seg + 1]
                      for b in range(n_seg)])            # [B, Q, seg + 1]
    n_ch = -(-seg // chunk)
    vsegs = np.empty((n_seg, len(names), n_ch * chunk), np.float32)
    for b in range(n_seg):
        end = min(b * seg + n_ch * chunk, padded.shape[1])
        vsegs[b, :, :end - b * seg] = padded[:, b * seg:end]
        vsegs[b, :, end - b * seg:] = padded[:, -1:]
    return lens, dt, seg, n_seg, n_ch, seg_v, vsegs


def _chunk_times(ci: int, chunk: int, dt: float, device) -> torch.Tensor:
    """Local times of samples [ci chunk, (ci + 1) chunk) at dt (f32)."""
    return (ci * chunk + torch.arange(chunk, dtype=torch.float32,
                                      device=device)) * dt


def _popsweep_segment_currents(rec_sc, rec_y, rec_k, n_acc, n_valid, mask,
                               vseg, dt, c, q_req, n_ch, chunk):
    """One segment's currents [P, Q_req, n_ch chunk] from the popsweep
    record stream, evaluated a chunk at a time (the record gather stays
    bounded); a dead lane's are inf."""
    parts = []
    for ci in range(n_ch):
        ys = _dense_eval_popsweep_ft(
            rec_sc, rec_y, rec_k, n_acc, n_valid,
            _chunk_times(ci, chunk, dt, rec_sc.device))[:, :q_req]
        vv = vseg[:q_req, ci * chunk:(ci + 1) * chunk]
        parts.append(gate_current(ys, vv[None], c))      # [P, Qr, chunk]
    ii = torch.cat(parts, dim=-1)
    return torch.where(mask[:, :q_req, None], ii,
                       torch.full_like(ii, float("inf")))


def simulate_population_real(kind: str, pop_params, names: list[str],
                             c: Constants, *, trips: int = 6144,
                             seg_samples: int = 103_224,
                             rtol: float = 1e-5, atol: float = 1e-7,
                             cull: bool = True, chunk: int = 4096,
                             voltages: dict | None = None) -> dict:
    """Currents of a POPULATION of nets on the named recordings -> {name:
    [P, N] numpy f32 at every sample}: the popsweep chained over
    ``seg_samples``-long segments on local f32 clocks.  All P members x Q
    protocols advance in the same launches; a protocol shorter than the
    longest holds its final value and is sliced back to its own length.  A
    (member, protocol) lane that died at any point is inf over its whole
    trace.  NN-f / NN-d only.  ``voltages`` {name: (v_samples, dt_ms)}
    stands in for the recordings."""
    nets, rg, hh = _pop_split(kind, pop_params)
    dev = nets[0][0].device
    lens, dt, seg, n_seg, n_ch, seg_v, vsegs = _segment_recordings(
        names, seg_samples=seg_samples, chunk=chunk, voltages=voltages)
    vsegs = torch.as_tensor(vsegs, device=dev)
    p_mem = nets[0][0].shape[0]
    out = {n: np.empty((p_mem, ln), np.float32)
           for n, ln in zip(names, lens)}
    fin = {}

    def consume(b, recs):
        # deadness rides the chain (final_state carries NaN), so the last
        # segment's mask is the survival flag
        fin["mask"] = recs.mask[:, :len(names)]
        ii = _popsweep_segment_currents(
            recs.rec_sc, recs.rec_y, recs.rec_k, recs.n_acc, recs.n_valid,
            recs.mask, vsegs[b], float(dt), c, len(names), n_ch,
            chunk).cpu().numpy()
        g0 = b * seg
        for qi, n in enumerate(names):
            lo, hi = g0, min(g0 + seg, lens[qi])
            if lo < hi:
                out[n][:, lo:hi] = ii[:, qi, :hi - lo]

    fused_nnf_popsweep_chained(
        nets, rg, torch.as_tensor(seg_v, device=dev), proto_dt=float(dt),
        t_end=seg * float(dt), rtol=rtol, atol=atol, trips=trips,
        base_hh=hh, cull=cull, consume=consume)
    m = fin["mask"].cpu().numpy()
    for qi, n in enumerate(names):
        out[n][~m[:, qi]] = np.inf
    return out


def _popsweep_segment_reduce(nets, vknots, y0, vseg, tseg, wseg, acc, c, *,
                             rg, hh, trips, rtol, atol, dt, t_end, q_req,
                             n_ch, chunk, cull):
    """One segment of the validation chain, all on the device: the popsweep
    launch, its dense output a chunk at a time, and the weighted
    |pred - truth| sums added to acc [P, Q_req].  Returns (acc, the final
    state [P, Q_req, 2] for the next segment, the survival mask, the
    launch's executed and accepted trips as two int32 scalars on the
    device)."""
    recs = fused_nnf_popsweep_solve_ft(
        nets, rg, vknots, _time_on(vknots.device, t_end), proto_dt=dt,
        t_end=t_end, rtol=rtol, atol=atol, trips=trips, base_hh=hh, y0=y0,
        return_records=True, cull=cull)
    sums = []
    for ci in range(n_ch):
        ys = _dense_eval_popsweep_ft(
            recs.rec_sc, recs.rec_y, recs.rec_k, recs.n_acc, recs.n_valid,
            _chunk_times(ci, chunk, dt, vknots.device))[:, :q_req]
        sl = slice(ci * chunk, (ci + 1) * chunk)
        ii = gate_current(ys, vseg[None, :q_req, sl], c)  # [P, Qr, chunk]
        # where, not *: an out-of-span sample of a diverged lane would add
        # inf * 0 = NaN
        err = torch.where(wseg[None, :q_req, sl] > 0.5,
                          (ii - tseg[None, :q_req, sl]).abs(),
                          torch.zeros_like(ii))
        sums.append(err.sum(dim=-1))
    return (acc + torch.stack(sums).sum(dim=0), recs.final_state(t_end),
            recs.mask[:, :q_req], [recs.n_valid, recs.n_acc])


# The rollout-MAE chains captured as CUDA graphs, by their shapes and
# settings
_ROLLOUT_GRAPHS: dict = {}


def population_rollout_maes(kind: str, pop_params, names: list[str],
                            c: Constants, truth: dict, *,
                            spans: dict | None = None, trips: int = 6144,
                            seg_samples: int = 103_224, rtol: float = 1e-5,
                            atol: float = 1e-7, cull: bool = True,
                            chunk: int = 4096,
                            voltages: dict | None = None,
                            graph: bool = True) -> np.ndarray:
    """Rollout MAEs [P, len(names)] of a POPULATION of nets against the
    target traces ``truth`` {name: [>= N]}: simulate_population_real's
    chained integration, with the |pred - truth| reduction on the device.
    Only the [P, Q] sums and the y0 carry pass between segments, and the
    host fetches them once at the end: no host synchronisation inside the
    chain.  ``spans`` {name: (lo, hi)} scores a sample interval (table 1's
    Pr4 scores sweeps 1-3); a segment scores only its own [g0, g0 + seg)
    samples, never the chunk padding past them.  A lane that died at any
    point scores inf; a NaN sum stays NaN for the caller's rescore.

    On a CUDA device (``graph``, the default) the first call runs the chain
    eagerly and captures it as one CUDA graph per (shapes, names, trips,
    chunk and settings); each later call copies its weights and targets
    into the graph's inputs and replays it (the replay equals the eager
    chain bit for bit; ``graph=False`` runs it eagerly).

    The call is a ``rollout`` span (``utils/timing.py``) of phases
    ``rollout.prepare`` (segmentation, targets, weights, uploads and the
    copies into the graph's inputs), ``rollout.capture`` (the first call's
    eager chain and capture) or ``rollout.replay``, and ``rollout.fetch``
    (the one read of the results).  The chain also keeps
    each segment's executed and accepted trips on the device, graph or
    not; the fetch reads them with the sums and records them as the counts
    ``b1.trips_executed`` and ``b1.trips_accepted`` (``segment=b``).  Beside
    them it records, from the pass the launch took (on the card
    ``_trip_solve_cuda.last_pass``, host data read with no synchronisation;
    a replay's is the one its capture took, stored with its graph; on the
    CPU ``popsweep_plan``'s), ``b1.column_passes`` (the ring's
    passes over the widest layer, or slice where split; 0 where the launch
    takes mlp()), ``b1.stream_bytes`` (the packed member weights one
    right-hand side reads, padding included: the ring's rows, every rank's
    where split, or mlp()'s own weights) and ``b1.cluster_blocks`` (the
    blocks of a cluster that split a member's columns; 1 unsplit)."""
    nets, rg, hh = _pop_split(kind, pop_params)
    dev = nets[0][0].device
    p_mem = nets[0][0].shape[0]
    with span("rollout", kind=kind, members=p_mem, recordings=len(names)):
        with span("rollout.prepare"):
            lens, dt, seg, n_seg, n_ch, seg_v, vsegs = _segment_recordings(
                names, seg_samples=seg_samples, chunk=chunk,
                voltages=voltages)
            q_req = len(names)
            tsegs = np.zeros((n_seg, q_req, n_ch * chunk), np.float32)
            wsegs = np.zeros((n_seg, q_req, n_ch * chunk), np.float32)
            counts = np.empty(q_req, np.float64)
            for qi, n in enumerate(names):
                tr = np.asarray(truth[n], np.float32)
                if tr.shape[0] < lens[qi]:
                    raise ValueError(f"truth[{n!r}] has {tr.shape[0]} "
                                     f"samples, protocol has {lens[qi]}")
                lo, hi = (spans or {}).get(n, (0, lens[qi]))
                lo, hi = max(int(lo), 0), min(int(hi), lens[qi])
                counts[qi] = max(hi - lo, 1)
                for b in range(n_seg):
                    g0 = b * seg
                    e = min(g0 + n_ch * chunk, lens[qi])
                    if g0 < e:
                        tsegs[b, qi, :e - g0] = tr[g0:e]
                    # score only this segment's own samples: the chunk
                    # padding past seg comes again at the head of the next
                    # segment's grid
                    slo, shi = max(lo - g0, 0), min(hi - g0, seg)
                    if slo < shi:
                        wsegs[b, qi, slo:shi] = 1.0

            kw = dict(c=c, rg=rg, hh=hh, trips=int(trips), rtol=float(rtol),
                      atol=float(atol), dt=float(dt), t_end=seg * float(dt),
                      q_req=q_req, n_ch=n_ch, chunk=int(chunk),
                      cull=bool(cull))

            def chain(seg_v, vsegs, tsegs, wsegs, *weights):
                layers = list(zip(weights[0::2], weights[1::2]))
                y0 = _rest(p_mem, q_req, seg_v.device)
                acc = torch.zeros((p_mem, q_req), dtype=torch.float32,
                                  device=seg_v.device)
                mask, n_out = None, []
                for b in range(seg_v.shape[0]):
                    acc, y0, mask, n = _popsweep_segment_reduce(
                        layers, seg_v[b], y0, vsegs[b], tsegs[b], wsegs[b],
                        acc, **kw)
                    n_out += n
                # [segments, 2]: each launch's executed and accepted trips
                return acc, mask, torch.stack(n_out).view(-1, 2)

            sizes = [nets[0][0].shape[1]] + [w.shape[2] for w, _ in nets]

            def b1_plan(info):
                return (info.get("column_passes", 0),
                        weight_stream_bytes(sizes, p_mem, info),
                        info.get("cluster_size", 1))

            inputs = [torch.as_tensor(x, device=dev)
                      for x in (seg_v, vsegs, tsegs, wsegs)]
            inputs += [x for layer in nets for x in layer]
            key = g = None
            if dev.type == "cuda" and graph:
                key = (str(dev), kind, tuple(names), int(trips), int(chunk),
                       tuple(tuple(x.shape) for x in inputs),
                       tuple(float(x) for x in rg),
                       None if hh is None else tuple(float(x) for x in hh),
                       tuple(float(x) for x in c), float(dt), float(rtol),
                       float(atol), bool(cull))
                g = _ROLLOUT_GRAPHS.get(key)
                if g is not None:
                    for dst, src in zip(g.inputs, inputs):
                        dst.copy_(src)
        if g is not None:
            with span("rollout.replay"):
                acc, mask, n_trips = g.replay()
            plan = g.plan
        elif key is not None:
            with span("rollout.capture"):
                acc, mask, n_trips = chain(*inputs)
                g = Graph(chain, *[x.clone() for x in inputs])
                g.plan = plan = b1_plan(_trip_solve_cuda.last_pass)
                _ROLLOUT_GRAPHS[key] = g
        else:
            acc, mask, n_trips = chain(*inputs)
            plan = b1_plan(_trip_solve_cuda.last_pass if dev.type == "cuda"
                           else popsweep_plan(p_mem, q_req, sizes)[1])
        with span("rollout.fetch"):
            sums = acc.cpu().numpy().astype(np.float64)
            alive = mask.cpu().numpy()
            for b, (run, accepted) in enumerate(n_trips.cpu().tolist()):
                count("b1.trips_executed", run, segment=b)
                count("b1.trips_accepted", accepted, segment=b)
                count("b1.column_passes", plan[0], segment=b)
                count("b1.stream_bytes", plan[1], segment=b)
                count("b1.cluster_blocks", plan[2], segment=b)
    return np.where(alive, sums / counts[None, :], np.inf)
