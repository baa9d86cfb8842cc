"""The plain version of the fused popsweep solve (ops/fused_solve.py::
fused_nnf_popsweep_solve_ft, P member nets x Q protocols) against the Pallas
kernel of ionflux/ops/pallas_solve.py run with interpret=True: NN-f, NN-d,
odd Q, per-lane death, the pace cull, q_split, the record stream and
eval.simulate_population, and the mxu_bf16 mode.  Both run the same trip
algorithm in f32: the gates agree to 1e-4 away from the protocols' step
edges (``_torch_helpers.ts_between_edges`` says why not on them), the
executed trips (n_valid) are equal and the accepted steps agree to 5%."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import eval as JE
from ionflux.models import nn as JN
from ionflux.models import registry as JR
from ionflux.ops import pallas_solve as JK
from ionflux_torch import eval as TE
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR
from ionflux_torch.ops import fused_solve as TK

from _torch_helpers import (assert_close, both_families, jax_net, np_,
                            np_net, torch_net, ts_between_edges)

GATE_TOL = 1e-4
LEVELS = (-40.0, 20.0)


def _protos(levels=LEVELS):
    pj, pt = both_families("activation_protocol", levels)
    v = np.stack([np.asarray(p.v) for p in pj])
    return jnp.asarray(v, jnp.float32), torch.from_numpy(v)


def _records_pair(net, levels=LEVELS, **kw):
    """Both packages' PopsweepRecords for the same members and protocols."""
    vj, vt = _protos(levels)
    tsj, tst = ts_between_edges()
    kw = dict(proto_dt=1.0, trips=2048, return_records=True, **kw)
    rj = JK.fused_nnf_popsweep_solve_ft(jax_net(net), JR.HH_B06, vj, tsj,
                                        interpret=True, **kw)
    rt = TK.fused_nnf_popsweep_solve_ft(torch_net(net), TR.HH_B06, vt, tst,
                                        **kw)
    return rt, rj, tst, tsj


def _assert_same_solve(rt, rj, tst, tsj):
    assert int(rt.n_valid) == int(rj.n_valid)
    assert abs(int(rt.n_acc) - int(rj.n_acc)) <= 0.05 * int(rj.n_acc)
    np.testing.assert_array_equal(np_(rt.mask), np.asarray(rj.mask))
    ys_t = rt.evaluate(tst)
    assert ys_t.dtype == torch.float32
    assert_close(ys_t, rj.evaluate(tsj), atol=GATE_TOL)
    return ys_t


@pytest.mark.parametrize("case", ["nnf", "nnd", "odd_q"])
def test_popsweep_plain_matches_pallas_interpret(case):
    levels = (-40.0, 0.0, 20.0) if case == "odd_q" else LEVELS
    members = 1 if case == "nnd" else 3
    net = np_net(1, std=0.05 if case == "nnd" else 0.1, members=members)
    kw = dict(base_hh=JR.HH_B06) if case == "nnd" else {}
    rt, rj, tst, tsj = _records_pair(net, levels, **kw)
    # Q pads to a power of two by repeating the last row; the block follows
    # the record-ring rule
    q = 4 if case == "odd_q" else 2
    assert (rt.p, rt.q, rt.q_req) == (members, q, len(levels))
    assert tuple(rt.rec_k.shape) == (rt.rec_sc.shape[0], 7, members, q, 2)
    ys_t = _assert_same_solve(rt, rj, tst, tsj)
    assert tuple(ys_t.shape) == (members, len(levels), 80, 2)
    assert bool(torch.isfinite(ys_t).all())


def test_popsweep_block_rule_matches_reference():
    """Trips per block: 256 halved while block * 7 * 2Q * 128 * 4 bytes
    exceeds 6 MiB, never below 32; trips round up to whole blocks."""
    for q in (2, 4, 8, 16, 32):
        block = 256
        while block > 32 and block * 7 * 2 * q * 128 * 4 > 6 * 1024 * 1024:
            block //= 2
        assert TK.popsweep_block(q) == block
    assert [TK.popsweep_block(q) for q in (2, 4, 8, 16, 32)] == [
        256, 128, 64, 32, 32]
    net = torch_net(np_net(0, members=2))
    v = _protos()[1]
    recs = TK.fused_nnf_popsweep_solve_ft(
        net, TR.HH_B06, v, torch.tensor([8000.0]), proto_dt=1.0, trips=200,
        return_records=True)
    assert recs.rec_sc.shape[0] == 256              # 200 -> 1 block of 256
    assert int(recs.n_acc) < 0                      # shortfall: all inf
    assert bool(torch.isinf(recs.evaluate(torch.tensor([100.0]))).all())


def _stiff_member(net, k):
    """Member 1 of ``net`` made stiff: da/dt = -K (a - 0.5) for a >= 0
    (hidden unit 0 carries a through every layer)."""
    for w, b in net:
        w[1], b[1] = 0.0, 0.0
        w[1, 0, 0] = 1.0
    net[0][0][1, :, 0] = (0.0, 1.0)              # input 1 is a
    net[-1][0][1, 0, 0] = -k * JR.NETSCALE
    net[-1][1][1] = 0.5 * k * JR.NETSCALE
    return net


def _jax_grinder_net():
    """Member 1 as test_pallas.py::test_popsweep_pace_cull_reaps_grinder
    builds it: the (16, 1) last-layer pattern is also broadcast over the
    square middle layer, which makes da/dt ~ -1e6 K (a - 0.5)."""
    net = np_net(1, members=3)
    w0 = np.zeros((2, 16), np.float32)
    w0[1, 0] = 1.0
    w1 = np.zeros((16, 1), np.float32)
    w1[0, 0] = -1e3 * JR.NETSCALE
    for li, (w, b) in enumerate(net):
        w[1] = w0 if li == 0 else w1
        b[1] = 0.0 if li == 0 else 0.5 * 1e3 * JR.NETSCALE
    return net


@pytest.mark.parametrize("how", ["diverges", "pinned"])
def test_popsweep_per_lane_death(how):
    """Member 1 dies in both packages and the survivors still agree:
    'diverges' (weights x 1e6) goes non-finite; 'pinned' (the grinder net of
    test_pallas.py) still fails at the 2e-7 step floor, before any cull."""
    if how == "diverges":
        net = [(w * np.where(np.arange(3) == 1, 1e6, 1.0)[:, None, None]
                .astype(np.float32), b) for w, b in np_net(1, members=3)]
    else:
        net = _jax_grinder_net()
    rt, rj, tst, tsj = _records_pair(net, cull=False)
    assert not bool(rt.mask[1].any()) and bool(rt.mask[[0, 2]].all())
    ys_t = _assert_same_solve(rt, rj, tst, tsj)
    assert bool(torch.isinf(ys_t[1]).all())
    assert bool(torch.isfinite(ys_t[[0, 2]]).all())


def test_popsweep_pace_cull_reaps_grinder():
    """A stiff but solvable member (K = 10/ms) would spend the shared trip
    budget for everyone: without the cull the launch falls short (all inf);
    with it both packages cull the grinder at the same block and the healthy
    members complete."""
    net = _stiff_member(np_net(1, members=3), k=10.0)
    vt = _protos()[1]
    ys_nc = TK.fused_nnf_popsweep_solve_ft(
        torch_net(net), TR.HH_B06, vt, ts_between_edges()[1], proto_dt=1.0,
        trips=2048, cull=False)
    assert bool(torch.isinf(ys_nc).all())
    rt, rj, tst, tsj = _records_pair(net)
    assert not bool(rt.mask[1].any())
    ys_t = _assert_same_solve(rt, rj, tst, tsj)
    assert bool(torch.isinf(ys_t[1]).all())
    assert bool(torch.isfinite(ys_t[[0, 2]]).all())


def test_popsweep_q_split_is_exact_and_validated():
    """q_split tiles the rows in chunks (on the card: fewer rows per thread
    block); the result is the same bit for bit.  A q_split that does not
    divide the padded rows is refused up front."""
    net = torch_net(np_net(1, members=2))
    vt = _protos((-40.0, 20.0, 0.0, -20.0))[1]
    ts = ts_between_edges(step=200.0)[1]
    kw = dict(proto_dt=1.0, trips=2048)
    ys1 = TK.fused_nnf_popsweep_solve_ft(net, TR.HH_B06, vt, ts, **kw)
    for qs in (2, 4):
        ys = TK.fused_nnf_popsweep_solve_ft(net, TR.HH_B06, vt, ts,
                                            q_split=qs, **kw)
        assert torch.equal(ys, ys1), qs
    for bad in (0, 3, 8):
        with pytest.raises(ValueError, match="q_split"):
            TK.fused_nnf_popsweep_solve_ft(net, TR.HH_B06, vt, ts,
                                           q_split=bad, **kw)


def test_popsweep_records_y0_carry_and_final_state():
    """return_records: n_valid is whole blocks and bounds n_acc;
    final_state(t_end) is the dense output at t_end; a NaN y0 (a dead lane
    carried over from a previous launch) starts that lane dead."""
    net = np_net(2, members=2)
    rt, rj, tst, tsj = _records_pair(net, t_end=8000.0)
    n_valid, n_acc = int(rt.n_valid), int(rt.n_acc)
    assert n_valid % TK.popsweep_block(rt.q) == 0
    assert 0 < n_acc <= n_valid <= 2048
    assert n_valid == int(rj.n_valid)
    fin = rt.final_state(8000.0)
    assert tuple(fin.shape) == (2, 2, 2)
    assert torch.equal(fin, rt.evaluate(torch.tensor([8000.0]))[:, :, 0])
    assert_close(fin, rj.final_state(8000.0), atol=GATE_TOL)
    # chain: the final state carried in, with member 1 / row 0 marked dead
    y0 = fin.clone()
    y0[1, 0] = float("nan")
    vt = _protos()[1]
    ys = TK.fused_nnf_popsweep_solve_ft(torch_net(net), TR.HH_B06, vt, tst,
                                        proto_dt=1.0, trips=2048, y0=y0)
    assert bool(torch.isinf(ys[1, 0]).all())
    assert bool(torch.isfinite(ys[0]).all() and torch.isfinite(ys[1, 1]).all())


def test_popsweep_mxu_bf16_plain_rounds_operands():
    """mxu_bf16 rounds the MLP operands to bf16 with f32 sums: the currents
    move by O(2^-8) relative of their range, not more."""
    net = torch_net(np_net(0, members=2))
    vt = _protos((-40.0, 40.0))[1]
    ts = ts_between_edges()[1]
    kw = dict(proto_dt=1.0, trips=2048)
    y32 = TK.fused_nnf_popsweep_solve_ft(net, TR.HH_B06, vt, ts, **kw)
    y16 = TK.fused_nnf_popsweep_solve_ft(net, TR.HH_B06, vt, ts,
                                         mxu_bf16=True, **kw)
    assert bool(torch.isfinite(y16).all())
    dev = float((y32 - y16).abs().max())
    assert 0.0 < dev < 0.02


def _bf16_net(seed: int = 3, members: int = 2):
    """Hidden-layer biases near 1, whose low bits bf16 drops, and a small
    output layer, so that the gates stay O(1)."""
    rs = np.random.RandomState(seed + 100)
    net = np_net(seed, members=members)
    hidden = [(w, (1.0 + 0.1 * rs.randn(*b.shape)).astype(np.float32))
              for w, b in net[:-1]]
    w, b = net[-1]
    return hidden + [((0.3 * w).astype(np.float32), b)]


@pytest.mark.parametrize("q_req", [9, 4])
def test_popsweep_mxu_bf16_matches_pallas_interpret(q_req):
    """mxu_bf16 against the reference: bf16 weights and layer inputs with
    f32 sums.  Past 8 padded rows (Q = 9 pads to 16) the reference folds
    each bias into its bf16 weights (fold_bias), so the biases are rounded
    too, and the port rounds them there; at Q = 4 they stay f32.  The
    rounding moves these gates by over 10x the tolerance."""
    net = _bf16_net()
    levels = np.linspace(-40.0, 40.0, q_req)
    rt, rj, tst, tsj = _records_pair(net, levels, mxu_bf16=True)
    ys_t = _assert_same_solve(rt, rj, tst, tsj)
    assert bool(torch.isfinite(ys_t).all())
    # the same solve with the biases left f32
    vt = _protos(levels)[1]
    s = TK._popsweep_setup(torch_net(net), TR.HH_B06, vt, tst, 0.0, 1.0,
                           None, 1e-5, 1e-7, 2048, None, None, True, True, 1)
    f32_bias = dataclasses.replace(s, layers=[
        (w, b) for (w, _), (_, b) in zip(s.layers, torch_net(net))])
    out = TK._trip_solve_plain(f32_bias)
    ys_b = TK.PopsweepRecords(*out[:3], out[3][0], out[3][1], rt.p, rt.q,
                              q_req, out[4]).evaluate(tst)
    effect = float((ys_t - ys_b).abs().max())
    if q_req > 8:
        assert effect >= 10 * GATE_TOL
    else:
        assert effect == 0.0


def test_simulate_population_matches_reference_and_family():
    """eval.simulate_population (the popsweep path) against ionflux's
    simulate_population in interpret mode, and each member against the
    port's own per-member simulate_family (dopri5): currents are gates
    times (V - E), up to ~150 mV."""
    net = np_net(5, members=2)
    pj, pt = both_families("activation_protocol", LEVELS)
    # dopri5 starts at ts[0], so the grid starts at the protocols' t0
    t = np.concatenate([[0.0], np_(ts_between_edges()[1])])
    tsj, tst = jnp.asarray(t, jnp.float32), torch.from_numpy(t.astype(
        np.float32))
    jpop = JN.NNfParams(jax_net(net), JR.HH_B06)
    tpop = TN.NNfParams(TN.MLP(torch_net(net)), TR.HH_B06)
    i_t = TE.simulate_population("nnf", tpop, pt, tst, TR.SYNTHETIC,
                                 trips=2048)
    assert tuple(i_t.shape) == (2, 2, 81)
    i_j = JE.simulate_population("nnf", jpop, pj, tsj, JR.SYNTHETIC,
                                 trips=2048, interpret=True)
    assert_close(i_t, i_j, atol=150 * GATE_TOL)
    for m in range(2):
        member = TN.NNfParams(tpop.net.member(m), TR.HH_B06)
        i_fam = TE.simulate_family("nnf", member, pt, tst, TR.SYNTHETIC)
        assert_close(i_t[m], i_fam, atol=5e-3)


def test_simulate_population_splits_rows_and_nnd():
    """More than POPSWEEP_SPLIT_ROWS protocols run as launches of that many
    rows, each equal to its own launch; NN-d populations share member 0's
    analytic base."""
    assert TK.POPSWEEP_SPLIT_ROWS == JK.POPSWEEP_SPLIT_ROWS
    assert TK.POPSWEEP_MAX_ROWS == JK.POPSWEEP_MAX_ROWS
    net = np_net(3, members=2, n_nodes=8, std=0.05)
    levels = np.linspace(-40.0, 50.0, TK.POPSWEEP_SPLIT_ROWS + 2)
    _, pt = both_families("activation_protocol", levels)
    ts = ts_between_edges(step=400.0)[1]
    pop = TN.NNdParams(TN.MLP(torch_net(net)), TR.HH_B06)
    i_all = TE.simulate_population("nnd", pop, pt, ts, TR.SYNTHETIC,
                                   trips=2048)
    assert tuple(i_all.shape) == (2, len(levels), ts.shape[0])
    i_tail = TE.simulate_population("nnd", pop,
                                    pt[TK.POPSWEEP_SPLIT_ROWS:], ts,
                                    TR.SYNTHETIC, trips=2048)
    assert torch.equal(i_all[:, TK.POPSWEEP_SPLIT_ROWS:], i_tail)
    assert bool(torch.isfinite(i_all).all())
    with pytest.raises(ValueError, match="nnf/nnd"):
        TE.simulate_population("hh", pop, pt, ts, TR.SYNTHETIC)


def test_popsweep_plain_matches_pallas_interpret_past_256_wide():
    """A 2-member net with two 300-wide hidden layers, wider than one pass
    of the CUDA ring's threads (the kernel takes it in two passes per
    chunk): the plain version against the Pallas kernel in interpret mode,
    at the tolerances of the narrow nets.  The weights are scaled by
    1/sqrt(width) so the activations stay O(1) through the layers."""
    net = np_net(6, n_layers=1, n_nodes=300, std=0.1 * (16 / 300) ** 0.5,
                 members=2)
    assert [w.shape[2] for w, _ in net] == [300, 300, 1]
    rt, rj, tst, tsj = _records_pair(net)
    ys_t = _assert_same_solve(rt, rj, tst, tsj)
    assert tuple(ys_t.shape) == (2, 2, 80, 2)
    assert bool(torch.isfinite(ys_t).all())
