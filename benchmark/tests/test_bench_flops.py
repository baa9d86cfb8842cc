"""The work counts against hand sums on tiny shapes."""

import pytest

from benchmark import flops as F


def test_mlp_work_by_hand():
    # 2 -> 3 -> 4 -> 1: 6 + 12 + 4 MACs; biases 3 + 4 + 1
    assert F.mlp_work([2, 3, 4, 1]) == (22, 30)
    macs, params = F.mlp_work([2] + [200] * 6 + [1])
    assert (macs, params) == (200_600, 201_801)
    # s08 of Table S1: 10 hidden 500 x 500 layers
    macs, params = F.mlp_work([2] + [500] * 11 + [1])
    assert (macs, params) == (2_501_500, 2_507_001)


def test_rhs_ops_by_hand():
    assert F.rhs_ops([2, 3, 1], "nnf") == 2 * 9 + 8
    assert F.rhs_ops([2, 3, 1], "nnd") == 2 * 9 + 16


def test_trip_bound_by_hand():
    # 10 steps x 6 stages x 1,000 ops x 4 lanes = 240,000 operations
    ms, by = F.trip_bound(10, 4, 1000, 0)
    assert by == "operations"
    assert ms == pytest.approx(240_000 / 67e12 * 1e3)
    # bytes: records (2 + 2 x 4 + 14 x 4) x 4 bytes a step, plus the inputs
    ms, by = F.trip_bound(10, 4, 1, 10**9)
    assert by == "bytes"
    assert ms == pytest.approx((10**9 + 10 * 66 * 4) / 3.35e12 * 1e3)


def test_b1_work_sums_accepted_steps_only():
    out = F.b1_work([10, -3], 4, [2, 3, 1], "nnf", knots_per_segment=5,
                    members=2)
    assert out["b1_ops"] == 10 * 6 * (2 * 9 + 8) * 4
    in_bytes = 4 * (2 * 13 + 5)
    want = (F.trip_bound(10, 4, 26, in_bytes)[0]
            + F.trip_bound(0, 4, 26, in_bytes)[0])
    assert out["b1_bound_ms"] == pytest.approx(want)


def test_update_counts_by_hand():
    assert F.surface_update_ops([2, 3, 1], 5) == 6 * 9 * 5
    assert F.node_update_ops([2, 3, 1], 7) == 6 * 9 * 7
    # the cells' own counts: D2's surface and the act trainer
    assert F.surface_update_ops([2] + [200] * 6 + [1], 53_652) == \
        pytest.approx(6.458e10, rel=1e-3)
    assert F.node_update_ops([2] + [200] * 6 + [1], 300 * 8 * 4) == \
        pytest.approx(1.1554e10, rel=1e-3)
