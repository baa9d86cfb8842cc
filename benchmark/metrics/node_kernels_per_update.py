"""Device operations a neural-ODE training update runs, counted in the
trace."""

DRIVERS = ("node_train",)
UNIT = "kernels"


def read(tr):
    if not tr["ops"] or tr["units"] < 1:
        return None
    return len(tr["ops"]) / tr["units"]
