"""Work counts from shapes, and the card's bounds.

``mlp_work``, ``roofline`` and ``trip_bound`` are copies of chip_smoke.py's
arithmetic; the peaks are NVIDIA's published H100 SXM figures (dense, at
700 W).  Operations are counted as the algorithm needs them for these
inputs: a trip solve's accepted steps (not its executed or padded trips),
the lanes requested (not padded), an update's forward and backward pass
(not a rematerialised second forward)."""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# one gate's analytic rate: 2 exp (one operation each) and 6 multiplies
# and adds
GATE_OPS = 8
RK4_STAGES = 4
DP5_STAGES = 6     # right-hand sides of an accepted step (first same as last)


def mlp_work(sizes) -> tuple[int, int]:
    """(MACs of one MLP evaluation, parameters) of layer sizes [in, ...,
    out]."""
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return macs, macs + sum(sizes[1:])


def rhs_ops(sizes, kind: str) -> int:
    """Operations of one right-hand side of NN-f / NN-d on one lane."""
    macs, _ = mlp_work(sizes)
    return 2 * macs + GATE_OPS * (2 if kind == "nnd" else 1)


def roofline(ops: float, nbytes: float, flops: float = F32_FLOPS):
    """Least time (ms) for ``ops`` operations at ``flops`` per second and
    ``nbytes`` bytes, and which of the two bounds it."""
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def trip_bound(n_steps: int, lanes: int, rhs: int, in_bytes: int,
               flops: float = F32_FLOPS):
    """Bound of a trip solve: 6 right-hand sides of ``rhs`` operations per
    lane per step; the inputs read once and the steps' records (t, h, start
    y, 7 stages) written once."""
    return roofline(n_steps * DP5_STAGES * rhs * lanes,
                    in_bytes + n_steps * (2 + 2 * lanes + 7 * 2 * lanes) * 4,
                    flops)


def validate_in_bytes(sizes, members: int, knots: int) -> int:
    """Bytes a segment's launch reads once: every member's net and the
    knot voltages of its rows."""
    return 4 * (members * mlp_work(sizes)[1] + knots)


def b1_work(accepted, lanes: int, sizes, kind: str, knots_per_segment: int,
            members: int) -> dict:
    """B1's operations and bound over a chain's segments, given each
    segment's accepted steps (``accepted``; a negative count, a launch that
    fell short, as 0), summed."""
    rhs = rhs_ops(sizes, kind)
    in_bytes = validate_in_bytes(sizes, members, knots_per_segment)
    ops = ms = 0.0
    for n in accepted:
        n = max(int(n), 0)
        ops += n * DP5_STAGES * rhs * lanes
        ms += trip_bound(n, lanes, rhs, in_bytes)[0]
    return {"b1_ops": ops, "b1_bound_ms": ms}


def surface_update_ops(sizes, points: int) -> float:
    """Operations of one full-batch Adam update on the surface: the MLP's
    forward (2 per MAC) and backward (4 per MAC) on every point."""
    return 6.0 * mlp_work(sizes)[0] * points


def node_update_ops(sizes, rhs_evals: int) -> float:
    """Operations of one training update through a fixed-step solve: each
    right-hand side's MLP forward and backward (6 per MAC)."""
    return 6.0 * mlp_work(sizes)[0] * rhs_evals
