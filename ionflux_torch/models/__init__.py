from ionflux_torch.models import registry
from ionflux_torch.models.gt_a import gt_a_coeffs, gt_a_rhs
from ionflux_torch.models.hh import (
    a_gate_rhs,
    hh_rates,
    hh_rhs,
    hh_steady_state,
    r_gate_rhs,
)
from ionflux_torch.models.markov import (
    MARKOV_Y0_INACT,
    MARKOV_Y0_REST,
    markov_rates,
    markov_rhs,
)
from ionflux_torch.models.nn import (
    MLP,
    NNdParams,
    NNfParams,
    mlp_apply,
    mlp_init,
    mlp_sizes,
    nn_surface,
    nnd_init,
    nnd_rhs,
    nnd_surface,
    nnf_init,
    nnf_rhs,
)

__all__ = [
    "registry",
    "gt_a_coeffs",
    "gt_a_rhs",
    "hh_rhs",
    "hh_rates",
    "hh_steady_state",
    "a_gate_rhs",
    "r_gate_rhs",
    "markov_rhs",
    "markov_rates",
    "MARKOV_Y0_REST",
    "MARKOV_Y0_INACT",
    "MLP",
    "NNfParams",
    "NNdParams",
    "mlp_apply",
    "mlp_init",
    "mlp_sizes",
    "nnf_init",
    "nnf_rhs",
    "nnd_init",
    "nnd_rhs",
    "nn_surface",
    "nnd_surface",
]
