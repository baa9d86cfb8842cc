"""The span and count recorder of ``ionflux_torch/utils/timing.py`` and the
spans and counts the port records with it: ``population_rollout_maes``'
phases and B1's trips (equal, segment by segment, to what the chained
popsweep's ``consume`` sees), ``fit_chunk``, ``Trainer.step``, the kernel
builds, and the operator's ``--trace`` export.  Nothing here touches a
card, and nothing may synchronise one."""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from ionflux_torch import eval as TE
from ionflux_torch import protocols as TP
from ionflux_torch.fit import train as TF
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.ops import _build
from ionflux_torch.ops import fused_solve as TK
from ionflux_torch.utils import timing

from _torch_helpers import np_net, torch_net

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import common_torch  # noqa: E402
import train_neural_ode_torch as NO  # noqa: E402


def _since(t0: int, names=None):
    """The module recorder's spans that started at or after t0 (by name
    where ``names`` is given), oldest first."""
    got = sorted((s for s in timing.spans() if s.start_ns >= t0),
                 key=lambda s: s.start_ns)
    return [s for s in got if names is None or s.name in names]


@pytest.fixture
def no_sync(monkeypatch):
    """Any wait on a card raises."""
    def refuse(*a, **k):
        raise AssertionError("the recorder synchronised the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)


def test_spans_nest_with_parent_and_root_ids():
    rec = timing.Recorder()
    with rec.span("call", k=1) as top:
        with rec.span("phase.a") as a:
            with rec.span("phase.a.inner") as inner:
                pass
        with rec.span("phase.b") as b:
            pass
    with rec.span("next") as nxt:
        pass
    by = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["phase.a.inner", "phase.a",
                                             "phase.b", "call", "next"]
    assert by["call"].parent is None and by["call"].root == top
    assert by["call"].attrs == {"k": 1}
    assert (by["phase.a"].parent, by["phase.b"].parent) == (top, top)
    assert by["phase.a.inner"].parent == a
    assert {by[n].root for n in ("phase.a", "phase.a.inner",
                                 "phase.b")} == {top}
    assert (by["phase.b"].id, by["phase.a.inner"].id) == (b, inner)
    assert by["next"].parent is None and by["next"].root == nxt != top
    for s in rec.spans():
        assert s.start_ns <= s.end_ns
    assert by["call"].start_ns <= by["phase.a"].start_ns
    assert by["phase.b"].end_ns <= by["call"].end_ns


def test_span_closed_by_an_exception_is_recorded_and_unwinds():
    rec = timing.Recorder()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("failing"):
                raise ValueError("boom")
    assert [s.name for s in rec.spans()] == ["failing", "outer"]
    with rec.span("after") as after:
        rec.count("n", 1)
    last = rec.spans()[-1]
    assert last.parent is None and last.root == after
    assert rec.counts()[-1].span == after


def test_ring_keeps_the_newest_entries():
    rec = timing.Recorder(maxlen=8)
    for i in range(20):
        with rec.span(f"s{i}"):
            rec.count("i", i)
    assert [s.name for s in rec.spans()] == [f"s{i}" for i in range(12, 20)]
    assert [c.value for c in rec.counts()] == list(range(12, 20))
    assert timing.RING >= 1 << 16


def test_counts_carry_their_span_and_root():
    rec = timing.Recorder()
    rec.count("outside", 3)
    with rec.span("call") as top:
        with rec.span("fetch") as fetch:
            rec.count("trips", 7, segment=2)
    out, inside = rec.counts()
    assert (out.span, out.root, out.value) == (None, None, 3)
    assert (inside.span, inside.root, inside.name) == (fetch, top, "trips")
    assert inside.attrs == {"segment": 2}
    call = [s for s in rec.spans() if s.name == "call"][0]
    assert call.start_ns <= inside.ns <= call.end_ns


def test_threads_nest_their_own_spans():
    rec = timing.Recorder()
    ready, go = threading.Barrier(2), threading.Event()

    def work(name):
        with rec.span(name):
            ready.wait(timeout=10)
            with rec.span(name + ".inner"):
                go.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    by = {s.name: s for s in rec.spans()}
    assert by["a.inner"].parent == by["a"].id
    assert by["b.inner"].parent == by["b"].id
    assert by["a"].parent is None and by["b"].parent is None


def test_recorder_never_synchronises_the_card(no_sync):
    t0 = time.time_ns()
    with timing.span("call"):
        with timing.span("phase"):
            timing.count("x", 1)
    assert [s.name for s in _since(t0, ("call", "phase"))] == ["call",
                                                              "phase"]
    assert timing.counts()[-1].name == "x"


def _population(kind):
    """Two members of a 2 x 16 x 16 x 1 net on two stand-in recordings (an
    activation step to +20 and to -30 mV at 1 ms: 6,001 and 3,501
    samples), with noisy targets."""
    layers = torch_net(np_net(3, n_layers=1, n_nodes=16, members=2))
    wrap = TN.NNfParams if kind == "nnf" else TN.NNdParams
    pop = wrap(TN.MLP(layers), TR.HH_B06)
    volts = {n: (TP.activation_protocol(x, 1.0, device="cpu").v[:ln]
                 .numpy(), 1.0)
             for n, x, ln in (("a", 20.0, 6001), ("b", -30.0, 3501))}
    rs = np.random.RandomState(0)
    truth = {n: 0.01 * rs.randn(len(v)) for n, (v, _) in volts.items()}
    return pop, volts, truth


@pytest.mark.parametrize("kind", ["nnf", "nnd"])
def test_rollout_trips_equal_the_chained_popsweeps(kind, no_sync):
    """population_rollout_maes' b1.trips_executed / b1.trips_accepted of
    each segment equal the n_valid / n_acc that fused_nnf_popsweep_chained
    hands its consume on the same inputs; the call is a rollout span of
    prepare and fetch (the eager chain between them), every count inside
    the fetch."""
    pop, volts, truth = _population(kind)
    kw = dict(trips=1024, seg_samples=2048, chunk=512, rtol=1e-5,
              atol=1e-7)
    names = ["a", "b"]
    t0 = time.time_ns()
    maes = TE.population_rollout_maes(kind, pop, names, TR.SYNTHETIC, truth,
                                      voltages=volts, **kw)
    assert maes.shape == (2, 2) and np.isfinite(maes).all()

    nets, rg, hh = TE._pop_split(kind, pop)
    _, dt, seg, n_seg, _, seg_v, _ = TE._segment_recordings(
        names, seg_samples=kw["seg_samples"], chunk=kw["chunk"],
        voltages=volts)
    want = []
    TK.fused_nnf_popsweep_chained(
        nets, rg, torch.as_tensor(seg_v), proto_dt=float(dt),
        t_end=seg * float(dt), rtol=kw["rtol"], atol=kw["atol"],
        trips=kw["trips"], base_hh=hh,
        consume=lambda b, r: want.append((int(r.n_valid), int(r.n_acc))))
    assert len(want) == n_seg >= 3

    spans = _since(t0)
    top = [s for s in spans if s.name == "rollout"]
    assert len(top) == 1 and top[0].parent is None
    assert top[0].attrs == {"kind": kind, "members": 2, "recordings": 2}
    kids = [s.name for s in spans if s.parent == top[0].id]
    assert kids == ["rollout.prepare", "rollout.fetch"]
    fetch = [s for s in spans if s.name == "rollout.fetch"][0]
    counts = [c for c in timing.counts() if c.root == top[0].id]
    assert {c.span for c in counts} == {fetch.id}
    got = {name: [(c.attrs["segment"], c.value) for c in counts
                  if c.name == name]
           for name in ("b1.trips_executed", "b1.trips_accepted")}
    assert got["b1.trips_executed"] == [(b, w[0]) for b, w in
                                        enumerate(want)]
    assert got["b1.trips_accepted"] == [(b, w[1]) for b, w in
                                        enumerate(want)]


def test_fit_chunk_is_a_span_with_its_update_count(no_sync):
    net = TN.MLP(torch_net(np_net(1, n_layers=1, n_nodes=8)))
    x = torch.rand(64, 2)
    y = torch.rand(64)
    state = TF.init_opt_state(net)
    t0 = time.time_ns()
    _, _, losses = TF.fit_chunk(net, state, x, y, iters=3)
    assert losses.shape == (3,)
    (top,) = _since(t0, ("fit_chunk",))
    assert top.parent is None and top.attrs == {"iters": 3}
    (c,) = [c for c in timing.counts() if c.root == top.id]
    assert (c.name, c.value, c.span) == ("fit_chunk.updates_eager", 3,
                                         top.id)


def test_trainer_step_is_a_span_of_its_phases(no_sync):
    """Trainer.step in RK4 mode (eager off the card) on a small net over
    11 output times: a node.step span of node.forward, node.loss,
    node.backward and node.adam, in that order."""
    tp = TP.activation_protocol(20.0, dt_ms=1.0, device="cpu")
    ts = torch.linspace(0.0, 100.0, 11)
    data = torch.full((11,), 0.5)
    tr = NO.Trainer(torch_net(np_net(2, n_layers=1, n_nodes=8)), tp, ts,
                    torch.tensor([0.0, 1.0]), data, adjoint=False)
    t0 = time.time_ns()
    assert np.isfinite(float(tr.step()))
    spans = _since(t0)
    (top,) = [s for s in spans if s.name == "node.step"]
    assert top.parent is None and top.attrs == {"adjoint": False}
    assert [s.name for s in spans if s.parent == top.id] == [
        "node.forward", "node.loss", "node.backward", "node.adam"]
    assert all(s.root == top.id for s in spans)


def test_build_records_only_the_sources_it_compiles(tmp_path, monkeypatch):
    """ops.build spans the nvcc run of the missing sources, with one
    ops.builds count each; a build that finds every library runs nothing
    and records nothing."""
    have = tmp_path / "libhave.so"
    have.write_bytes(b"")
    paths = {"fused_solve": str(have), "hh_solve": str(tmp_path / "a.so"),
             "tridiag": str(tmp_path / "b.so")}
    monkeypatch.setattr(_build, "library_path", paths.__getitem__)
    compiled = []

    def compile_(names):
        compiled.append(list(names))
        return {n: (paths[n], "log") for n in names}

    monkeypatch.setattr(_build, "_compile", compile_)
    t0 = time.time_ns()
    out = _build.build(list(paths))
    assert compiled == [["hh_solve", "tridiag"]]
    assert out == {"fused_solve": (str(have), ""),
                   "hh_solve": (paths["hh_solve"], "log"),
                   "tridiag": (paths["tridiag"], "log")}
    (top,) = _since(t0, ("ops.build",))
    assert top.attrs == {"source": "hh_solve,tridiag"}
    builds = [c for c in timing.counts() if c.name == "ops.builds"
              and c.span == top.id]
    assert [(c.value, c.attrs["source"]) for c in builds] == [
        (1, "hh_solve"), (1, "tridiag")]
    t1 = time.time_ns()
    assert _build.build(["fused_solve"]) == {"fused_solve": (str(have), "")}
    assert compiled == [["hh_solve", "tridiag"]]
    assert not _since(t1, ("ops.build",))


def test_trace_export_carries_the_spans_on_the_profilers_clock(tmp_path):
    """--trace (common_torch.traced) appends the recorder's spans and counts
    of the block to trace.json under the process ionflux_torch: the file
    stays valid JSON, and a span contains the host operation it ran, as
    the profiler stamped it."""
    args = types.SimpleNamespace(trace=True)
    x = torch.randn(200, 200)
    with common_torch.traced(args, str(tmp_path)):
        with timing.span("export.call", k=1):
            with timing.span("export.matmul"):
                x @ x
                timing.count("export.count", 4, segment=1)
    with open(tmp_path / "trace" / "trace.json") as fh:
        trace = json.load(fh)
    ours = {e["name"]: e for e in trace["traceEvents"]
            if e.get("pid") == "ionflux_torch"}
    assert {"export.call", "export.matmul", "export.count"} <= set(ours)
    call, mm_span = ours["export.call"], ours["export.matmul"]
    assert call["ph"] == "X" and call["args"]["k"] == 1
    assert mm_span["args"]["parent"] == call["args"]["id"]
    assert ours["export.count"]["args"] == {"segment": 1, "value": 4,
                                            "span": mm_span["args"]["id"]}
    (mm,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert mm_span["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= mm_span["ts"] + mm_span["dur"]
    assert common_torch.add_recorded(str(tmp_path / "trace" / "trace.json"),
                                     time.time_ns() + 10**12) == 0
