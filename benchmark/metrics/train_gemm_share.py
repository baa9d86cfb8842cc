"""The share of the surface update's device time spent in matrix-product
kernels (cuBLAS / CUTLASS names: gemm, xmma, cutlass), from the trace."""

DRIVERS = ("surface_train",)
UNIT = "%"
GEMM = ("gemm", "xmma", "cutlass")


def read(tr):
    total = sum(d for _, _, d in tr["ops"])
    if total <= 0.0:
        return None
    mm = sum(d for name, _, d in tr["ops"]
             if any(k in name.lower() for k in GEMM))
    return 100.0 * mm / total
