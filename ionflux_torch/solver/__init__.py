from ionflux_torch.solver.adams import odeint_adams
from ionflux_torch.solver.adjoint import odeint_adjoint
from ionflux_torch.solver.analytic import (hh_solve_analytic,
                                           markov_solve_analytic)
from ionflux_torch.solver.batched import (odeint_batched,
                                          odeint_batched_chunked)
from ionflux_torch.solver.chained import odeint_chained
from ionflux_torch.solver.dopri5 import SolveStats, odeint
from ionflux_torch.solver.fixed import odeint_rk4
from ionflux_torch.solver.implicit import odeint_rosenbrock
from ionflux_torch.solver.vcabm import odeint_vcabm

__all__ = ["odeint", "odeint_rk4", "odeint_chained", "odeint_adams",
           "odeint_adjoint", "odeint_batched", "odeint_vcabm",
           "odeint_rosenbrock", "odeint_batched_chunked", "SolveStats",
           "hh_solve_analytic", "markov_solve_analytic"]
