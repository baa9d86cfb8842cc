"""B1's weight bytes against the card's HBM, where the members outgrow the
L2: the byte bound of the accepted steps (``b1_hbm_roofline``) and the time
the bytes B1 streamed would take at the HBM's rate (``b1_stream_share``).
The constants are benchmark/flops.py's; the L2 is the H100 SXM's 50 MiB
(``torch.cuda.get_device_properties(0).L2_cache_size`` reads 52,428,800 on
the card).  Where the members fit the L2 there is no HBM bound to read:
both give None."""

from __future__ import annotations

from benchmark import flops

L2_BYTES = 50 * 2**20
# right-hand sides B1 evaluates a trip, accepted or not: csrc/fused_solve.cu
# attempt() runs stages 1-6, stage 0 being the last accepted step's seventh
RHS_PER_TRIP = 6


def member_bytes(sizes, members: int) -> int:
    """The members' weights and biases in float32."""
    return 4 * members * flops.mlp_work(sizes)[1]


def b1_hbm_bound_ms(accepted, sizes, members: int, knots_per_segment: int):
    """Least HBM time (ms) of B1's accepted steps over a chain's segments:
    each step's 6 right-hand sides read every member's weights and biases,
    all but the L2's worth from HBM, and each segment's knots are read
    once (a negative count, a launch that fell short, as 0); None where the
    members fit the L2."""
    spill = member_bytes(sizes, members) - L2_BYTES
    if spill <= 0:
        return None
    nbytes = sum(max(int(n), 0) * flops.DP5_STAGES * spill
                 + 4 * knots_per_segment for n in accepted)
    return nbytes / flops.HBM_BYTES_PER_S * 1e3


def b1_stream_ms(segments):
    """Time (ms) at the HBM's rate of the weight bytes B1 streamed over
    (executed trips, bytes a right-hand side reads) of each segment, 6
    right-hand sides a trip; None where no segment's stream outgrows the
    L2."""
    if not any(nbytes > L2_BYTES for _, nbytes in segments):
        return None
    nbytes = sum(max(int(run), 0) * RHS_PER_TRIP * int(b)
                 for run, b in segments)
    return nbytes / flops.HBM_BYTES_PER_S * 1e3
