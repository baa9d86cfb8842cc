"""Table S1's widest NN-f, s08 (10 hidden 500 x 500 layers), on the
checkpoint-validation path (``eval.population_rollout_maes``): at s08's
depth against the benchmark's plain float64 reference
(``benchmark/reference/validate.py``), the launch plan and the weight bytes
a right-hand side streams at s08's widths, the counts the call records, and
the two per-layer readers of B1's HBM stream (``benchmark/hbm.py``).

This file imports no JAX, so its card test runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_s08_validate.py
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import flops, hbm  # noqa: E402
from benchmark import harness as H  # noqa: E402
from benchmark.reference import validate as RV  # noqa: E402
from ionflux_torch import eval as TE  # noqa: E402
from ionflux_torch.models.nn import MLP, NNfParams  # noqa: E402
from ionflux_torch.models.registry import (ARCHITECTURES, Constants,  # noqa
                                           HHParams)
from ionflux_torch.ops import fused_solve as TK  # noqa: E402
from ionflux_torch.utils import timing  # noqa: E402
from ionflux_torch.utils.timing import Count, Span  # noqa: E402

N_LAYERS, N_NODES = ARCHITECTURES["s08"]
S08 = [2] + [N_NODES] * (N_LAYERS + 1) + [1]
NARROW = [2] + [24] * (N_LAYERS + 1) + [1]      # s08's depth, 24 wide
# the r1 constants and the s08 checkpoint's gate (model-entire.spec.json)
GATE = [1.13e-4, 7.45e-2, 3.6e-5, 4.49e-2, 8.732437e-2, 7.3338e-3,
        6.16551e-3, 3.157413e-2]
G_NS, E_MV = 0.16067785, -93.4
# the cell's solver settings (benchmark/traffic/table1-40.json) and the
# reference's tolerances
SOLVER = dict(rtol=1e-6, atol=1e-8)
REF_TOL = dict(rtol=1e-7, atol=1e-9)
# the program (float32, rtol 1e-6) against the float64 reference, each MAE
# relative: read 5.9e-6 on the CPU at s08's depth; the reference solved in
# float32 at the program's tolerances reads 4.2e-5 there, so 1e-4 is float32
# at these tolerances with room, and 17x the reading
CPU_MAE_RTOL = 1e-4


def _members(sizes, p: int, seed: int, device="cpu"):
    """p members of He-scaled normal weights and small biases, float32."""
    gen = torch.Generator().manual_seed(seed)
    return [((torch.randn(p, a, b, generator=gen) * (2.0 / a) ** 0.5)
             .to(device),
             (0.1 * torch.randn(p, b, generator=gen)).to(device))
            for a, b in zip(sizes[:-1], sizes[1:])]


def _step(n: int, level: float) -> np.ndarray:
    """A step protocol at 0.1 ms: -80 mV, -120 mV from sample 500, the test
    level from 1,000, -80 mV for the last 500 samples."""
    v = np.full(n, -80.0, np.float32)
    v[500:] = -120.0
    v[1000:] = level
    v[n - 500:] = -80.0
    return v


def _maes(layers, volts, truth, gate=GATE, **kw):
    pop = NNfParams(MLP(layers), HHParams(*[np.float32(x) for x in gate]))
    return TE.population_rollout_maes(
        "nnf", pop, list(volts), Constants(np.float32(G_NS), np.float32(E_MV)),
        truth, voltages=volts, **kw)


def _reference(layers, volts, truth, device, gate=GATE):
    names = list(volts)
    sol = RV.solve("nnf", [(w.to(device), b.to(device)) for w, b in layers],
                   gate, [torch.as_tensor(volts[n][0], device=device)
                          for n in names], 0.1, **REF_TOL)
    return RV.score(sol, [torch.as_tensor(truth[n], device=device)
                          for n in names],
                    [(0, len(volts[n][0])) for n in names], G_NS,
                    float(np.float32(E_MV))).cpu().numpy()


def _counts(name):
    last = max(s.id for s in timing.spans() if s.name == "rollout")
    return [c.value for c in timing.counts()
            if c.root == last and c.name == name]


def test_rollout_maes_at_s08_depth_match_the_reference():
    """3 seeded members at s08's depth (10 hidden layers, narrowed to 24
    wide) on two step recordings, chained over three segments: the
    program's MAEs against the plain float64 reference, and one count of
    each kind a segment, the stream bytes those of the ring's packed rows."""
    layers = _members(NARROW, 3, seed=19)
    volts = {"a": (_step(3001, 20.0), 0.1), "b": (_step(2501, -40.0), 0.1)}
    rng = np.random.default_rng(19)
    truth = {n: (0.1 * rng.standard_normal(len(v))).astype(np.float32)
             for n, (v, _) in volts.items()}
    got = _maes(layers, volts, truth, trips=4096, seg_samples=1200,
                chunk=512, **SOLVER)
    ref = _reference(layers, volts, truth, "cpu")
    assert np.isfinite(got).all() and got.shape == (3, 2)
    np.testing.assert_allclose(got, ref, rtol=CPU_MAE_RTOL, atol=0)
    packed, _, _ = TK._ring_pack(layers, False)
    assert _counts("b1.stream_bytes") == [packed.numel() * 4] * 3
    assert _counts("b1.column_passes") == [1] * 3
    assert len(_counts("b1.trips_executed")) == 3


def test_s08_plan_takes_the_ring_in_two_column_passes():
    """40 members on the five recordings (Q pads to 8): the ring pass at 8
    rows a block, each 500-wide layer in 2 column passes; launch_plan of the
    setup the popsweep builds agrees."""
    rt, info, _ = TK.popsweep_plan(40, 5, S08)
    assert (rt, info) == (8, dict(layer_pass="ring", row_tile=8,
                                  column_passes=2))
    assert TK.population_pass(8, S08, False) == (rt, info)
    layers = [(torch.zeros(1, 1, 1).expand(40, a, b),
               torch.zeros(1, 1).expand(40, b))
              for a, b in zip(S08[:-1], S08[1:])]
    s = TK._Setup(layers=layers, vpad=torch.zeros(8, 384),
                  y0=torch.zeros(40, 8, 2), gate=(0.0,) * 4, base_a=(),
                  t0=0.0, dt_knot=0.1, t_end=1.0, rtol=1e-6, atol=1e-8,
                  trips=256, block=256, cull=True, ring=True, q_real=5)
    assert TK.launch_plan(s) == (rt, info)


def test_s08_stream_bytes_equal_the_ring_pack():
    """The bytes one right-hand side of s08's launch streams are the ring's
    packed rows, padding included (the 1-wide last layer padded to 4
    columns): 2,503,000 floats a member, on CPU tensors, no launch."""
    layers = _members(S08, 2, seed=3)
    rt, info, nbytes = TK.popsweep_plan(2, 5, S08)
    packed, _, _ = TK._ring_pack(layers, False,
                                 TK._ring_cap(rt, S08, False))
    assert packed.shape == (2, 2 * 500 + 10 * 500 * 500 + 500 * 4)
    assert nbytes == packed.numel() * 4
    assert TK.popsweep_plan(40, 5, S08)[2] == 40 * packed.shape[1] * 4


def test_mlp_pass_streams_its_own_weights():
    """Past the ring's widest layer the popsweep takes mlp(): 0 column
    passes, and each member's row-major weights, unpadded."""
    wide = [2, 11520, 11520, 1]
    _, info, nbytes = TK.popsweep_plan(3, 5, wide)
    assert info["layer_pass"] == "mlp" and info.get("column_passes", 0) == 0
    assert nbytes == 3 * 4 * (2 * 11520 + 11520 * 11520 + 11520)


# The readers of B1's HBM stream on a synthetic trace: one traced rollout
# of two segments (s08's widths, 40 members), its counts, and 2 trip kernels

MS = 1_000_000          # ns
INFO = dict(sizes=S08, kind="nnf", members=40, lanes=200, knots=10)


def _trace(monkeypatch, stream_bytes=(400_480_000, 400_480_000)):
    spans = [Span(10, None, 10, "rollout", 100 * MS, 130 * MS, {}),
             Span(20, None, 20, "rollout", 300 * MS, 330 * MS, {})]
    counts = []
    for root, runs, accs in ((10, (300, 200), (100, -1)),
                             (20, (900, 900), (9, 9))):
        for b in (0, 1):
            counts.append(Count(root, root, "b1.trips_executed", 0, runs[b],
                                {"segment": b}))
            counts.append(Count(root, root, "b1.trips_accepted", 0, accs[b],
                                {"segment": b}))
            if stream_bytes:
                counts.append(Count(root, root, "b1.stream_bytes", 0,
                                    stream_bytes[b], {"segment": b}))
    monkeypatch.setattr(timing, "spans", lambda: spans)
    monkeypatch.setattr(timing, "counts", lambda: counts)
    us = 1e3
    return dict(host=[("aten::randperm", 100 * us, 101 * us),
                      ("cudaDeviceSynchronize", 125 * us, 130 * us)],
                ops=[("void trip_kernel<8>", 110 * us, 400_000.0),
                     ("void trip_kernel<8>", 115 * us, 600_000.0),
                     ("gemv", 120 * us, 100.0)],
                gaps=[], calls=1, info=INFO, plain_s=0.03, peak=67e12)


def test_hbm_readers_give_their_hand_computed_values(monkeypatch):
    """b1_hbm_roofline: the traced call's 100 accepted steps (segment 1 fell
    short, as 0) x 6 x (40 x 2,507,001 x 4 - 50 MiB) bytes and 2 x 10
    knots, at 3.35 TB/s, over 1,000 ms of trip_kernel; b1_stream_share:
    500 executed trips x 6 x 400,480,000 bytes at 3.35 TB/s over the same."""
    tr = _trace(monkeypatch)
    spill = 40 * 2_507_001 * 4 - 52_428_800
    want_ms = (100 * 6 * spill + 2 * 10 * 4) / 3.35e12 * 1e3
    readers = H.readers()
    assert readers["b1_hbm_roofline"].read(tr) == pytest.approx(
        100.0 * want_ms / 1000.0)
    assert readers["b1_stream_share"].read(tr) == pytest.approx(
        100.0 * (500 * 6 * 400_480_000 / 3.35e12 * 1e3) / 1000.0)
    assert hbm.member_bytes(S08, 40) == 4 * 40 * flops.mlp_work(S08)[1]


def test_hbm_readers_read_nothing_where_nothing_is_counted(monkeypatch):
    """No stream bytes counted (a program without the count): no
    b1_stream_share; no trip kernel in the trace, or nothing counted:
    neither; members that fit the L2 (64 of the 5 x 200 net, 51.7 MB):
    neither."""
    readers = H.readers()
    tr = _trace(monkeypatch, stream_bytes=())
    assert readers["b1_stream_share"].read(tr) is None
    assert readers["b1_hbm_roofline"].read(tr) is not None
    tr = _trace(monkeypatch)
    tr["ops"] = []
    assert readers["b1_stream_share"].read(tr) is None
    assert readers["b1_hbm_roofline"].read(tr) is None
    tr = _trace(monkeypatch)
    monkeypatch.setattr(timing, "counts", lambda: [])
    assert readers["b1_stream_share"].read(tr) is None
    assert readers["b1_hbm_roofline"].read(tr) is None
    d1 = [2] + [200] * 6 + [1]
    tr = _trace(monkeypatch, stream_bytes=(64 * 201_800 * 4,) * 2)
    tr["info"] = dict(INFO, sizes=d1, members=64)
    assert hbm.member_bytes(d1, 64) < hbm.L2_BYTES
    assert readers["b1_hbm_roofline"].read(tr) is None
    assert readers["b1_stream_share"].read(tr) is None


# On the card (marked cuda; it skips where there is none)

# the cell's limit (benchmark/workloads/s08.validate.json)
CARD_MAE_GAP = float(H.load_json("workloads", "s08.validate")["limits"]
                     ["mae_gap"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_s08_members_on_the_graph_path_on_card(card):
    """4 members of the committed s08 checkpoint, each leaf x (1 + 0.01
    N(0, 1)) (the cell's population, benchmark/gen.py), on Pr3's first two
    sweeps (to -60 and +60 mV: two segments of the cell's 103,224 samples)
    through population_rollout_maes' graph path (capture, then a replay):
    the replay's MAEs equal the capture's and lie within the cell's mae_gap
    of the float64 reference; each call counts the plan's column passes and
    stream bytes, a segment each."""
    from benchmark import gen

    mix = H.load_json("traffic", "table1-40")
    layers, gate = gen.population(
        gen.npz_leaves(H.load_json("configs", "nn-f-s08")["checkpoint"]), 4,
        mix["spread"], 8, card)
    assert gate == pytest.approx(GATE, rel=1e-6)
    pr3 = dict(mix["recordings"][0], test_mv=[-60.0, 60.0])
    pr3["n"] = pr3["first"] + 2 * pr3["period"]
    v, dt = gen.recording(pr3)
    volts = {"pr3-like": (v.astype(np.float32), dt)}
    gen_t = torch.Generator().manual_seed(8)
    truth = {"pr3-like": (0.1 * torch.randn(len(v), generator=gen_t)).numpy()}
    TE._ROLLOUT_GRAPHS.clear()
    kw = dict(mix["solver"])
    first = _maes(layers, volts, truth, gate, **kw)
    replay = _maes(layers, volts, truth, gate, **kw)
    assert len(TE._ROLLOUT_GRAPHS) == 1
    assert np.array_equal(first, replay) and np.isfinite(first).all()
    _, info, nbytes = TK.popsweep_plan(4, 1, S08)
    assert info["column_passes"] == 2
    assert _counts("b1.column_passes") == [2] * 2
    assert _counts("b1.stream_bytes") == [nbytes] * 2
    ref = _reference(layers, volts, truth, card, gate)
    gap = float(np.max(np.abs(replay - ref) / np.abs(ref)))
    print(f"mae_gap {gap!r} (limit {CARD_MAE_GAP})")
    assert gap <= CARD_MAE_GAP
