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

import dataclasses
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


# The split ring pass (B1 on clusters where the widest layer takes more
# than one column pass)

L2 = 52_428_800                              # the H100's L2 (bytes)
D1 = [2] + [200] * 6 + [1]                   # d1 / d2's widths
S02 = [2] + [200] * 11 + [1]                 # Table S1's s02 (10 x 200)
S07 = [2, 500, 500, 1]                       # s07 (1 x 500)


def _pass(sizes, row_tile=8, bf16=False):
    return TK.population_pass(row_tile, sizes, bf16)[1]


@pytest.mark.parametrize("sizes,p,row_tile,bf16,clusters,want", [
    (S08, 40, 8, False, {2: 66, 3: 43, 4: 31}, 3),
    (S08, 40, 8, False, {2: 66, 3: 39, 4: 31}, 2),
    (S08, 40, 8, False, {2: 39, 3: 39, 4: 39}, 1),
    (S08, 40, 8, False, {}, 1),
    (S07, 40, 8, False, {2: 66, 3: 39, 4: 30}, 2),
    (S07, 4, 16, False, {2: 66, 3: 39, 4: 30}, 4),
    (D1, 64, 8, False, {2: 66, 3: 44, 4: 33}, 1),
    (D1, 66, 8, False, {2: 66, 3: 44, 4: 33}, 1),
    (S02, 64, 8, False, {2: 66, 3: 44, 4: 33}, 1),
    (S08, 40, 8, True, {2: 66, 3: 43, 4: 31}, 1),
    (S08, 40, 1, False, {2: 66, 3: 43, 4: 31}, 1),
    ([2, 11520, 11520, 1], 40, 8, False, {2: 66, 3: 43, 4: 31}, 1),
], ids=["s08-C3", "s08-C2", "s08-none-held", "s08-no-card-facts",
        "s07-in-L2", "s07-16-rows", "d1-64-in-L2", "d1-66-past-L2",
        "s02-past-L2", "bf16", "one-row", "mlp"])
def test_ring_split_rule(sizes, p, row_tile, bf16, clusters, want):
    """The size rule as a pure function of the launch and the clusters of
    the split kernel the card holds at once: a net whose widest layer
    takes two column passes (s08, s07: 500 wide) splits at the largest C
    whose p clusters the card holds, whether its members fit the L2 (s07
    at 40 members, 40 MB) or not (s08, 401 MB); nets of one pass (d1 / d2
    at 64 members, 51.5 MB, and at 66, past the L2; s02 at 64, 103 MB)
    stay whole, as do bf16, the one-row population solve and mlp()."""
    info = _pass(sizes, row_tile, bf16)
    got = TK.ring_split(sizes, p, 1, info, bf16, clusters)
    assert got == want
    if info["layer_pass"] == "ring" and not bf16 and row_tile > 1:
        assert (info["column_passes"] > 1) == (max(sizes) > 256)
        if max(sizes) <= 256:
            assert got == 1
    if sizes in (D1, S02):        # the L2 does not decide it
        assert (TK.weight_stream_bytes(sizes, p, info) > L2) == (
            sizes == S02 or p > 64)
    if want > 1:
        assert TK.ring_split_fits(row_tile, sizes, want)
        assert clusters[want] >= p and all(
            clusters.get(c, 0) < p or not TK.ring_split_fits(
                row_tile, sizes, c)
            for c in TK.RING_SPLIT_SIZES if c > want)


@pytest.mark.parametrize("sizes,csize,fits", [
    (S08, 2, True), (S08, 3, True), (S08, 4, True),
    ([2, 4, 4, 1], 3, False),         # a 4-wide hidden layer: no slice
    ([2, 2000, 2000, 1], 2, False),   # 1,000 columns: not one pass
    ([2, 500, 1], 3, False),          # no hidden layer to slice
])
def test_ring_split_fits(sizes, csize, fits):
    """The split takes a net where each hidden layer is wider than its
    slice and a slice takes one pass of the block's 256 threads (4 row
    groups x cols / 4 column groups at 8 rows), and the stages and the two
    exchange buffers fit a block; a forced split that does not fit
    raises."""
    assert TK.ring_split_fits(8, sizes, csize) is fits
    assert not TK.ring_split_fits(1, sizes, csize)
    if fits:
        stage = TK.ring_split_geometry(sizes, csize,
                                       TK._ring_cap(8, sizes, False))[2]
        assert TK.ring_split_smem_bytes(8, max(sizes), stage) <= (
            232448 - 1024)
    else:
        with pytest.raises(ValueError, match="split ring pass"):
            TK._ring_split_pass(sizes, 40, 1, _pass(sizes), False, "cpu",
                                csize)


@pytest.mark.parametrize("sizes", [S08, NARROW, [2, 37, 37, 37, 1],
                                   [2, 130, 257, 130, 1]],
                         ids=["s08", "narrow", "37", "130-257"])
@pytest.mark.parametrize("csize", [2, 3, 4])
def test_ring_split_pack_reassembles_the_ring(sizes, csize):
    """Every rank's row of ``_ring_split_pack`` put back together equals the
    ring's packed weights: the whole layers (0 and the last) equal in every
    rank, the sliced layers' column blocks side by side; every padding is
    zero, every chunk 16-byte aligned, and the kernel inputs carry the
    split's rows and columns."""
    assert TK.ring_split_fits(8, sizes, csize)
    p = 2
    layers = _members(sizes, p, seed=csize)
    cap = TK._ring_cap(8, sizes, False)
    packed, geom, stage, cols = TK._ring_split_pack(layers, csize, cap)
    ring, rgeom, _ = TK._ring_pack(layers, False, cap)
    ranks = packed.reshape(p, csize, -1)
    assert cols == TK.ring_split_columns(sizes, csize)
    assert (geom, packed.shape[1], stage) == TK.ring_split_geometry(
        sizes, csize, cap)
    used = torch.zeros(ranks.shape[2], dtype=torch.bool)
    for l, ((d_in, d_out), (off, kc, nch), c, (roff, _, _)) in enumerate(
            zip(zip(sizes[:-1], sizes[1:]), geom, cols, rgeom)):
        assert off % 4 == 0 and (kc * c) % 4 == 0 and nch * kc >= d_in
        used[off:off + d_in * c] = True
        blocks = ranks[:, :, off:off + d_in * c].reshape(p, csize, d_in, c)
        want = ring[:, roff:roff + d_in * _round4(d_out)].reshape(
            p, d_in, _round4(d_out))
        if l in (0, len(cols) - 1):
            assert c == _round4(d_out)
            assert all(torch.equal(blocks[:, q], want) for q in range(csize))
            continue
        assert c < d_out <= c * csize and c % 4 == 0
        side = torch.cat(list(blocks.unbind(1)), dim=2)  # [p, in, C cols]
        assert torch.equal(side[..., :d_out], want[..., :d_out])
        assert not side[..., d_out:].any()
    assert not ranks[:, :, ~used].any()
    info = dict(layer_pass="ring", row_tile=8, column_passes=1,
                cluster_size=csize)
    assert TK.weight_stream_bytes(sizes, p, info) == packed.numel() * 4


def _round4(n):
    return -(-n // 4) * 4


def test_forced_split_reaches_the_kernel_inputs():
    """``_Setup.cluster`` on a ring launch: -1 the rule (unsplit off the
    card), 0 or 1 unsplit, C > 1 the split at C (the launch plan names its
    cluster size and one column pass; the kernel inputs carry the ranks'
    rows and (0, columns) per layer); a C that does not take the launch
    raises.  weight_stream_bytes counts every rank's bytes."""
    layers = _members(NARROW, 3, seed=5)
    s = TK._Setup(layers=layers, vpad=torch.zeros(8, 384),
                  y0=torch.zeros(3, 8, 2), gate=(0.0,) * 4, base_a=(),
                  t0=0.0, dt_knot=0.1, t_end=1.0, rtol=1e-6, atol=1e-8,
                  trips=256, block=256, cull=True, ring=True, q_real=5)
    base = TK.launch_plan(s)
    assert base == (8, dict(layer_pass="ring", row_tile=8, column_passes=1))
    for c in (0, 1):
        assert TK.launch_plan(dataclasses.replace(s, cluster=c)) == base
    rt, info = TK.launch_plan(dataclasses.replace(s, cluster=3))
    assert (rt, info) == (8, dict(base[1], cluster_size=3))
    wflat, ring, _, _, _, cluster = TK._kernel_inputs(
        dataclasses.replace(s, cluster=3), rt, "ring", 3)
    packed, geom, stage, cols = TK._ring_split_pack(
        layers, 3, TK._ring_cap(8, NARROW, False))
    assert torch.equal(wflat, packed) and ring[1] == stage
    assert list(ring[0]) == list(sum(geom, ()))
    assert cluster[0] == 3 and cluster[2] == 0
    assert list(cluster[1]) == [x for c in cols for x in (0, c)]
    assert TK.weight_stream_bytes(NARROW, 3, info) == packed.numel() * 4
    with pytest.raises(ValueError, match="split ring pass"):
        TK.launch_plan(dataclasses.replace(s, cluster=3, bf16=True))
    one_row = dataclasses.replace(s, y0=torch.zeros(3, 1, 2),
                                  vpad=torch.zeros(1, 384), cluster=2)
    with pytest.raises(ValueError, match="split ring pass"):
        TK.launch_plan(one_row)


def test_s08_split_stream_bytes_count_every_rank():
    """At C = 3 each of s08's 40 members streams 3 rank rows a right-hand
    side: the 10 hidden layers' 168-column slices (164 real in the last
    rank) and the two whole layers in every rank, 843,000 floats a rank,
    404,640,000 bytes in all against the unsplit 400,480,000."""
    info = TK._split_info(_pass(S08), 3)
    assert info == dict(layer_pass="ring", row_tile=8, column_passes=1,
                        cluster_size=3)
    per_rank = 2 * 500 + 10 * 500 * 168 + 500 * 4
    assert TK.weight_stream_bytes(S08, 40, info) == 40 * 3 * per_rank * 4
    assert TK.popsweep_plan(40, 5, S08) == (8, _pass(S08), 400_480_000)


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
    of the float64 reference; each call counts the column passes, stream
    bytes and cluster blocks of the pass the launch took, a segment each:
    s08's 500-wide layers take two column passes unsplit, so the size rule
    splits the 4 members over clusters of 4 blocks, one pass each."""
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
    unsplit = TK.popsweep_plan(4, 1, S08)[1]
    assert unsplit["column_passes"] == 2
    info = TK._trip_solve_cuda.last_pass
    assert info == dict(unsplit, column_passes=1, cluster_size=4)
    assert _counts("b1.column_passes") == [1] * 2
    assert _counts("b1.stream_bytes") == [
        TK.weight_stream_bytes(S08, 4, info)] * 2
    assert _counts("b1.cluster_blocks") == [4] * 2
    ref = _reference(layers, volts, truth, card, gate)
    gap = float(np.max(np.abs(replay - ref) / np.abs(ref)))
    print(f"mae_gap {gap!r} (limit {CARD_MAE_GAP})")
    assert gap <= CARD_MAE_GAP


@pytest.mark.cuda
def test_s08_split_matches_the_unsplit_launch_on_card(card, monkeypatch):
    """The split ring pass forced at C = 2 and C = 3 through
    ``_Setup.cluster`` against C = 1, on 4 members of the cell's s08
    population and Pr3's first two sweeps: the first segment's popsweep
    records (rec_sc, rec_y, rec_k over the executed trips, n_out, the
    mask) and population_rollout_maes' MAEs equal to the last bit; on the
    graph path the replay equals the capture, and each call counts the
    plan's cluster blocks and stream bytes, a segment each."""
    from benchmark import gen

    mix = H.load_json("traffic", "table1-40")
    layers, gate = gen.population(
        gen.npz_leaves(H.load_json("configs", "nn-f-s08")["checkpoint"]), 4,
        mix["spread"], 8, card)
    pr3 = dict(mix["recordings"][0], test_mv=[-60.0, 60.0])
    pr3["n"] = pr3["first"] + 2 * pr3["period"]
    v, dt = gen.recording(pr3)
    volts = {"pr3-like": (v.astype(np.float32), dt)}
    gen_t = torch.Generator().manual_seed(8)
    truth = {"pr3-like": (0.1 * torch.randn(len(v), generator=gen_t)).numpy()}
    kw = dict(mix["solver"])
    seg = kw["seg_samples"]
    knots = torch.as_tensor(volts["pr3-like"][0][:seg + 1], device=card)[None]
    setup = TK._popsweep_setup
    got = {}
    for c in (1, 2, 3):
        monkeypatch.setattr(TK, "_popsweep_setup", lambda *a, c=c, **k:
                            dataclasses.replace(setup(*a, **k), cluster=c))
        recs = TK.fused_nnf_popsweep_solve_ft(
            layers, HHParams(*gate), knots,
            torch.tensor([seg * dt], device=card), proto_dt=dt,
            t_end=seg * dt, rtol=kw["rtol"], atol=kw["atol"],
            trips=kw["trips"], return_records=True)
        n = int(recs.n_valid)
        assert TK._trip_solve_cuda.last_pass.get("cluster_size", 1) == c
        TE._ROLLOUT_GRAPHS.clear()
        first = _maes(layers, volts, truth, gate, **kw)
        replay = _maes(layers, volts, truth, gate, **kw)
        assert len(TE._ROLLOUT_GRAPHS) == 1
        assert np.array_equal(first, replay) and np.isfinite(first).all()
        info = TK._split_info(TK.popsweep_plan(4, 1, S08)[1], c)
        nbytes = TK.weight_stream_bytes(S08, 4, info)
        assert _counts("b1.cluster_blocks") == [c] * 2
        assert _counts("b1.stream_bytes") == [nbytes] * 2
        got[c] = (recs.rec_sc[:n].cpu(), recs.rec_y[:n].cpu(),
                  recs.rec_k[:n].cpu(), recs.n_acc.cpu(), recs.n_valid.cpu(),
                  recs.mask.cpu(), first)
        print(f"C = {c}: {n} executed trips, {int(recs.n_acc)} accepted, "
              f"stream {nbytes} bytes")
    for c in (2, 3):
        for a, b in zip(got[1][:-1], got[c][:-1]):
            assert torch.equal(a, b)
        assert np.array_equal(got[1][-1], got[c][-1])
