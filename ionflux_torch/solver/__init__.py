from ionflux_torch.solver.chained import odeint_chained
from ionflux_torch.solver.dopri5 import SolveStats, odeint

__all__ = ["odeint", "odeint_chained", "SolveStats"]
