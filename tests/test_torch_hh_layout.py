"""The layout rules of the HH population kernels (ops/hh_solve.py::
hh_trip_geometry and rk4_geometry) and the work each thread of
csrc/hh_solve.cu takes under them, by the kernels' own index arithmetic
(``_trip_roles``, ``_rk4_roles``): for every lane count the kernels take, a
block stays within its 512 threads and 227 KB of shared memory, and every
lane's chain, rates and records have exactly one owner.  Pure Python on the
CPU; the kernels themselves run in the card tests of
tests/test_torch_package.py."""

import numpy as np
import pytest

from ionflux_torch.ops import hh_solve as TH

LANES = range(1, TH.MAX_LANES + 1)


def _check_trip(b):
    geo = TH.hh_trip_geometry(b)
    g = geo["group"]
    assert geo["threads"] % 32 == 0
    assert geo["threads"] <= TH.MAX_THREADS
    assert geo["smem_bytes"] <= TH._SMEM_BYTES
    assert geo["chain_warps"] == -(-b // 32) <= 4    # the kernel's partials
    n_chain = 32 * geo["chain_warps"]
    assert geo["threads"] - n_chain >= b * g          # a helper per member
    chain, rate, record = TH._trip_roles(b)
    # each lane's chain on its own thread, all in the chain warps; every
    # rate and record of every lane on a helper thread
    assert sorted(chain.tolist()) == list(range(b))
    assert bool((rate >= n_chain).all()) and bool((record >= n_chain).all())
    # ... and on exactly one: the members' strided sets tile 0..19, 0..7
    for n in (TH.TRIP_RATES, TH.TRIP_RECORDS):
        owners = [m for m in range(g) for _ in range(m, n, g)]
        assert sorted(q for m in range(g) for q in range(m, n, g)) == \
            list(range(n)) and len(owners) == n
    # a helper serves one lane
    helpers = {}
    for lane in range(b):
        for t in set(rate[lane].tolist()) | set(record[lane].tolist()):
            assert helpers.setdefault(t, lane) == lane
    return geo


def test_trip_rule_for_every_lane_count():
    """The rule's helpers per lane: the largest of TRIP_GROUPS whose chain
    and helper warps fit 512 threads (20, one rate per helper, up to 24
    lanes; 3 at 128); the layout holds at each count."""
    for b in LANES:
        geo = _check_trip(b)
        fits = [g for g in TH.TRIP_GROUPS
                if -(-b // 32) * 32 + -(-b * g // 32) * 32 <= TH.MAX_THREADS]
        assert geo["group"] == max(fits), b
    assert TH.hh_trip_geometry(8)["group"] == 20        # the fit's 8 lanes
    assert TH.hh_trip_geometry(8)["threads"] == 32 + 160
    assert TH.hh_trip_geometry(128)["group"] == 3


@pytest.mark.parametrize("group", TH.TRIP_GROUPS)
def test_trip_rule_picks_each_build(group):
    """Each of the kernel's builds is the rule's choice for a range of lane
    counts, and only where its threads fit a block; lane counts out of
    range are refused."""
    picked = [b for b in LANES if TH.hh_trip_geometry(b)["group"] == group]
    assert picked and picked == list(range(picked[0], picked[-1] + 1))
    for b in picked:
        assert -(-b // 32) * 32 + -(-b * group // 32) * 32 <= TH.MAX_THREADS
    with pytest.raises(ValueError):
        TH.hh_trip_geometry(0)
    with pytest.raises(ValueError):
        TH.hh_trip_geometry(TH.MAX_LANES + 1)


def test_rk4_lane_spread():
    """Lanes over blocks: each lane has one consumer thread in warp 0 of
    one block and each of its 12 rates one producer thread of that block
    (warps 1..); a block stays within the thread and shared-memory limits."""
    lanes = TH.RK4_LANES
    for b in LANES:
        geo = TH.rk4_geometry(b)
        assert geo["threads"] <= TH.MAX_THREADS and geo["threads"] % 32 == 0
        assert geo["smem_bytes"] <= TH._SMEM_BYTES
        assert geo["blocks"] == -(-b // lanes)
        assert geo["producers"] >= lanes * TH.RK4_RATES
        consumer, producer = TH._rk4_roles(b)
        assert bool((consumer >= 0).all()) and bool((producer >= 0).all())
        assert len({tuple(c) for c in consumer}) == b
        assert bool((consumer[:, 1] < 32).all())
        assert bool((producer[:, :, 1] >= 32).all())
        assert bool((producer[:, :, 0] == consumer[:, None, 0]).all())
        pairs = {tuple(p) for p in producer.reshape(-1, 2)}
        per_thread = -(-lanes * TH.RK4_RATES // geo["producers"])
        assert len(pairs) * per_thread >= min(b, lanes) * TH.RK4_RATES


def test_rk4_rule():
    """The rule's spread, and refusals."""
    geo = TH.rk4_geometry(128)
    assert geo["lanes_per_block"] == TH.RK4_LANES
    assert geo["blocks"] == -(-128 // TH.RK4_LANES)
    for bad in (0, 129):
        with pytest.raises(ValueError):
            TH.rk4_geometry(bad)
