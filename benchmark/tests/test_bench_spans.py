"""The seven readers of the program's own spans and counts (benchmark/
spans.py): on a synthetic trace with recorded spans, which calls they take
(the traced call from the trace's host events, the untraced ones just
before) and None where there is nothing to read; end to end on the CPU at a
toy size; and on the card, that the graph path's trip counts equal the
launch records of one more eager chain, that a span shares the profiler's
clock, and that nothing the program records reaches the trace's device
operations."""

import time

import pytest
import torch

from benchmark import flops
from benchmark import harness as H
from benchmark import spans as S
from benchmark.tests.test_bench_faults import (SEED, tiny_node_mix,
                                               tiny_surface_mix,
                                               tiny_validate_mix)
from ionflux_torch.utils import timing
from ionflux_torch.utils.timing import Count, Span

NAMES = ("b1_accepted_share", "b1_trip_us", "b1_roofline", "mfu.validate",
         "validate_prep_ms", "train_enqueue_ms", "node_enqueue_ms")
# the shapes drivers/validate.py's trace_info gives
INFO = dict(sizes=[2, 3, 1], kind="nnf", members=2, lanes=4, knots=10)
MS = 1_000_000          # ns


def read(name, tr):
    return H.readers()[name].read(tr)


def _span(i, name, start_ms, end_ms, parent=None, root=None):
    return Span(i, parent, root or i, name, start_ms * MS, end_ms * MS, {})


def _validate_trace(monkeypatch):
    """Two untraced rollouts before the trace's window (100-200 ms), one
    inside it, one after; each with its counts (two segments); a trace of
    two trip kernels and three idle gaps."""
    spans, counts = [], []
    for k, (t, run, acc) in enumerate([(10, 900, 400), (40, 800, 300),
                                       (120, 1000, 450), (300, 700, 10)]):
        top = 10 * (k + 1)
        spans += [_span(top + 1, "rollout.prepare", t, t + 10, top, top),
                  _span(top + 2, "rollout.replay", t + 10, t + 30, top, top),
                  _span(top, "rollout", t, t + 30)]
        counts += [Count(top + 1, top, "b1.trips_executed", 0, run // 2,
                         {"segment": b}) for b in (0, 1)]
        counts += [Count(top + 1, top, "b1.trips_accepted", 0, acc // 2,
                         {"segment": b}) for b in (0, 1)]
    monkeypatch.setattr(timing, "spans", lambda: spans)
    monkeypatch.setattr(timing, "counts", lambda: counts)
    us = 1e3      # ms in the trace's microseconds
    return dict(
        host=[("aten::randperm", 100 * us, 101 * us),
              ("cudaDeviceSynchronize", 190 * us, 200 * us)],
        ops=[("void trip_kernel<8>", 150 * us, 2000.0),
             ("void trip_kernel<8>", 160 * us, 3000.0),
             ("gemv", 170 * us, 100.0)],
        # idle 115-125 ms (half inside the prepare span 120-130 ms),
        # 126-128 ms (inside), 135-140 ms (outside)
        gaps=[(115 * us, 125 * us), (126 * us, 128 * us),
              (135 * us, 140 * us)],
        calls=1, info=INFO, plain_s=0.03, peak=67e12)


def test_validate_readers_take_the_traced_call(monkeypatch):
    tr = _validate_trace(monkeypatch)
    assert read("b1_accepted_share", tr) == pytest.approx(45.0)
    assert read("b1_trip_us", tr) == pytest.approx(5000.0 / 1000)
    assert read("validate_prep_ms", tr) == pytest.approx(7.0)
    # B1's work on the traced call's two segments of 225 accepted trips
    work = flops.b1_work([225, 225], 4, [2, 3, 1], "nnf",
                         knots_per_segment=10, members=2)
    assert read("b1_roofline", tr) == pytest.approx(
        100.0 * work["b1_bound_ms"] / 5.0)
    assert read("mfu.validate", tr) == pytest.approx(
        100.0 * work["b1_ops"] / (0.03 * 67e12))
    tr["calls"] = 2
    assert read("validate_prep_ms", tr) == pytest.approx(3.5)


@pytest.mark.parametrize("calls,want", [(1, 30.0), (2, 25.0), (3, 20.0),
                                        (5, 20.0)])
def test_untraced_readers_take_the_last_calls_before_the_window(
        monkeypatch, calls, want):
    spans = [_span(1, "fit_chunk", 0, 10), _span(2, "fit_chunk", 40, 60),
             _span(3, "fit_chunk", 70, 100),       # ends at the window
             _span(4, "fit_chunk", 110, 500),      # the traced call
             _span(5, "node.step", 10, 20), _span(6, "node.step", 30, 50),
             _span(7, "node.step", 120, 900)]
    monkeypatch.setattr(timing, "spans", lambda: spans)
    monkeypatch.setattr(timing, "counts", lambda: [])
    tr = dict(host=[("aten::mm", 100e3, 101e3), ("x", 150e3, 700e3)],
              ops=[], gaps=[], calls=calls)
    assert read("train_enqueue_ms", tr) == pytest.approx(want)
    assert read("node_enqueue_ms", tr) == pytest.approx(
        20.0 if calls == 1 else 15.0)


def test_readers_return_none_with_nothing_to_read(monkeypatch):
    tr = _validate_trace(monkeypatch)
    # no host events: no window
    empty = dict(tr, host=[])
    for name in NAMES:
        assert read(name, empty) is None, name
    # no span or count of these names
    monkeypatch.setattr(timing, "spans", lambda: [])
    monkeypatch.setattr(timing, "counts", lambda: [])
    for name in NAMES:
        assert read(name, tr) is None, name
    # a program with no recorder (an older timing module)
    monkeypatch.delattr(timing, "spans")
    monkeypatch.delattr(timing, "counts")
    assert S.recorded() is None
    for name in NAMES:
        assert read(name, tr) is None, name


def test_no_trip_kernel_reads_no_trip_time(monkeypatch):
    tr = _validate_trace(monkeypatch)
    tr["ops"] = [op for op in tr["ops"] if "trip_kernel" not in op[0]]
    assert read("b1_trip_us", tr) is None
    assert read("b1_roofline", tr) is None
    assert read("b1_accepted_share", tr) == pytest.approx(45.0)
    assert read("mfu.validate", tr) > 0.0


@pytest.mark.parametrize("workload,mix,names", [
    ("nnf.validate", tiny_validate_mix,
     ("b1_accepted_share", "validate_prep_ms", "mfu.validate")),
    ("nnd.train", tiny_surface_mix, ("train_enqueue_ms",)),
    ("nnf.node_train", tiny_node_mix, ("node_enqueue_ms",))])
def test_traced_run_reports_the_span_metrics_on_the_cpu(workload, mix,
                                                        names):
    """A traced run at a toy size on the CPU: each cell's span metrics are
    in the result line (no device trace, so no trip time)."""
    from benchmark import run

    torch.set_num_threads(2)
    out = run.main(["--workload", workload, "--seed", str(SEED),
                    "--seconds", "0.01", "--trace", "1"], mix=mix(),
                   device="cpu")
    assert out["correct"]
    for name in names:
        assert out["metrics"][name]["value"] >= 0.0, name
    assert "b1_trip_us" not in out["metrics"]
    assert "b1_roofline" not in out["metrics"]
    if "b1_accepted_share" in names:
        assert 0.0 < out["metrics"]["b1_accepted_share"]["value"] <= 100.0


# On the card


def eager_chain_trips(run) -> list[tuple[int, int]]:
    """(executed, accepted) trips of each segment of one more eager chain
    on a validate run's inputs, read from its launch records (the reading
    of scripts/probe_validation_chain_torch.py::chain_segments)."""
    from ionflux_torch.models.registry import HHParams
    from ionflux_torch.ops import fused_solve as F

    hh, kw = HHParams(*run.gate), run.kw
    _, dt, seg, _, _, seg_v, _ = run.E._segment_recordings(
        run.names, seg_samples=kw["seg_samples"], chunk=kw["chunk"],
        voltages=run.voltages)
    stats = []

    def consume(b, recs):
        stats.append(torch.stack([recs.n_valid.float(),
                                  recs.n_acc.float()]))

    F.fused_nnf_popsweep_chained(
        run.layers, hh, torch.as_tensor(seg_v, device=run.cell.device),
        proto_dt=float(dt), t_end=seg * float(dt), rtol=kw["rtol"],
        atol=kw["atol"], trips=kw["trips"],
        base_hh=hh if run.kind == "nnd" else None, consume=consume)
    return [(int(r[0]), int(r[1])) for r in torch.stack(stats).tolist()]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nnf.validate", "nnd.validate"])
def test_graph_path_trips_equal_chain_trips(name, card):
    """A replayed validation call's b1.trips_* equal, segment by segment,
    the launch records of one more eager chain."""
    cell = H.Cell.find(name, seed=2**31 + 91)
    cell.device = card
    run = cell.driver().setup(cell)
    t0 = time.time_ns()
    run.call()
    (top,) = [s for s in timing.spans() if s.name == "rollout"
              and s.start_ns >= t0]
    kids = {s.name for s in timing.spans() if s.parent == top.id}
    assert "rollout.replay" in kids and "rollout.capture" not in kids
    got = {n: [c.value for c in timing.counts() if c.root == top.id
               and c.name == n]
           for n in ("b1.trips_executed", "b1.trips_accepted")}
    segs = eager_chain_trips(run)
    assert got["b1.trips_executed"] == [n for n, _ in segs]
    assert got["b1.trips_accepted"] == [a for _, a in segs]
    run.release()


@pytest.mark.cuda
def test_span_shares_the_profilers_clock(card):
    """A span around one kernel launch contains that launch's host event
    (cudaLaunchKernel) in harness.device_trace, within 50 us at each end.
    The profiler's first launch pays its own set-up (54 us on an H100), so
    one launch runs under it before the span."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with timing.span("clock.probe") as sid:
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    (s,) = [s for s in timing.spans() if s.id == sid]
    tr = H.device_trace(prof)
    launch = max((h for h in tr["host"] if "LaunchKernel" in h[0]),
                 key=lambda h: h[1])
    lo, hi = s.start_ns / 1e3, s.end_ns / 1e3
    assert 0.0 <= launch[1] - lo <= 50.0, (launch, lo, hi)
    assert 0.0 <= hi - launch[2] <= 50.0, (launch, lo, hi)


@pytest.mark.cuda
def test_recorded_events_stay_out_of_the_device_operations(card):
    """A validation call at a stand-in size under the profiler (its capture
    and a replay): the trace's device operations are the same with and
    without the recorder's events, and none carries a recorded name."""
    from torch.profiler import ProfilerActivity, profile

    cell = H.Cell.find("nnd.validate", seed=2**31 + 93,
                       mix=tiny_validate_mix())
    cell.device = card
    run = cell.driver().setup(cell)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        run.call()
        torch.cuda.synchronize()
    names = {s.name for s in timing.spans() if s.start_ns >= t0}
    names |= {c.name for c in timing.counts() if c.ns >= t0}
    assert {"rollout", "rollout.replay", "b1.trips_executed"} <= names
    ops = H.device_trace(prof)["ops"]
    assert ops and not {n for n, _, _ in ops} & names
    assert not [n for n, _, _ in ops if n.startswith(("rollout", "b1.",
                                                      "graph.", "ops."))]
    run.release()
