from ionflux_torch.solver.analytic import (hh_solve_analytic,
                                           markov_solve_analytic)
from ionflux_torch.solver.batched import (odeint_batched,
                                          odeint_batched_chunked)
from ionflux_torch.solver.chained import odeint_chained
from ionflux_torch.solver.dopri5 import SolveStats, odeint

__all__ = ["odeint", "odeint_chained", "odeint_batched",
           "odeint_batched_chunked", "SolveStats", "hh_solve_analytic",
           "markov_solve_analytic"]
