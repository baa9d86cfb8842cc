"""The model kinds and leaves the recorded-protocol path adds to
ionflux_torch.eval and observe, against ionflux: the 6-state Markov model
and its reduced a-gate (``gta``) through solve_states / simulate,
markov_current, add_noise, default_y0, pad_protocol and simulate_cases
(mirroring tests/test_eval.py).  Both solve the same smooth f32 systems
with the same controller, so states and currents agree to 1e-4 of their
range at output times 50 ms and more from a step edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import eval as JE
from ionflux import observe as JO
from ionflux import protocols as JP
from ionflux.models import gt_a as JG
from ionflux.models import registry as JR
from ionflux_torch import eval as TE
from ionflux_torch import observe as TO
from ionflux_torch import protocols as TP
from ionflux_torch.models import gt_a as TG
from ionflux_torch.models import registry as TR

from _torch_helpers import assert_close, np_, ts_between_edges

RANGE_TOL = 1e-4


def _close_in_range(port, ref):
    ref = np.asarray(ref)
    assert_close(port, ref, atol=RANGE_TOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("kind", ["markov", "gta"])
@pytest.mark.parametrize("step", [-40.0, 20.0])
def test_markov_and_gta_solves_match(kind, step):
    tsj, tst = ts_between_edges()
    prj = JP.activation_protocol(step, dt_ms=1.0)
    prt = TP.activation_protocol(step, dt_ms=1.0, device="cpu")
    ys = TE.solve_states(kind, TR.MARKOV_B06, prt, tst)
    assert tuple(ys.shape) == (80, 6 if kind == "markov" else 2)
    assert ys.dtype == torch.float32
    _close_in_range(ys, JE.solve_states(kind, JR.MARKOV_B06, prj, tsj))
    _close_in_range(TE.simulate(kind, TR.MARKOV_B06, prt, tst, TR.SYNTHETIC),
                    JE.simulate(kind, JR.MARKOV_B06, prj, tsj, JR.SYNTHETIC))


def test_gt_a_coeffs_rhs_and_markov_current_match():
    rs = np.random.RandomState(0)
    v = (-120.0 + 180.0 * rs.rand(64)).astype(np.float32)
    y2 = rs.rand(64, 2).astype(np.float32)
    y6 = rs.rand(64, 6).astype(np.float32)
    for got, want in zip(TG.gt_a_coeffs(TR.MARKOV_B06, torch.from_numpy(v)),
                         JG.gt_a_coeffs(JR.MARKOV_B06, jnp.asarray(v))):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=2e-6)
    np.testing.assert_allclose(
        np_(TG.gt_a_rhs(TR.MARKOV_B06, 0.0, torch.from_numpy(y2),
                        torch.from_numpy(v))),
        np.asarray(JG.gt_a_rhs(JR.MARKOV_B06, 0.0, jnp.asarray(y2),
                               jnp.asarray(v))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np_(TO.markov_current(torch.from_numpy(y6), torch.from_numpy(v),
                              TR.TABLE1)),
        np.asarray(JO.markov_current(jnp.asarray(y6), jnp.asarray(v),
                                     JR.TABLE1)), rtol=1e-6, atol=1e-6)


def test_default_y0_per_kind():
    for kind in ("hh", "markov", "nnf", "nnd", "gta"):
        got = TE.default_y0(kind)
        want = np.asarray(JE.default_y0(kind, jnp.float32))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(np_(got), want)
    with pytest.raises(ValueError, match="not ported"):
        TE.default_y0("lstm")


def test_add_noise_adds_sigma_times_the_generators_normals():
    """The two packages draw from different generators, so the noise is
    copied across: each adds sigma times its own stream's standard normals
    (the port's from a torch.Generator, bit for bit), and the port's noise
    has mean 0 and standard deviation sigma."""
    i = torch.linspace(-5.0, 5.0, 100_000)
    got = TO.add_noise(torch.Generator().manual_seed(7), i, sigma=0.1)
    z = torch.randn(i.shape, generator=torch.Generator().manual_seed(7))
    assert got.dtype == torch.float32 and torch.equal(got, i + 0.1 * z)
    noise = (got - i).double()
    assert abs(float(noise.mean())) < 2e-3
    assert abs(float(noise.std()) - 0.1) < 2e-3
    assert TO.NOISE_SIGMA == JO.NOISE_SIGMA
    key = jax.random.PRNGKey(3)
    ij = jnp.asarray(np_(i))
    np.testing.assert_array_equal(
        np.asarray(JO.add_noise(key, ij, 0.1)),
        np.asarray(ij + 0.1 * jax.random.normal(key, ij.shape, ij.dtype)))


def test_pad_protocol_is_result_invariant():
    """tests/test_eval.py::test_pad_protocol_is_result_invariant, in both
    packages: the padded knots repeat the last value."""
    proto = TP.activation_protocol(0.0, dt_ms=1.0, device="cpu")
    padded = TE.pad_protocol(proto, proto.v.shape[-1] + 5000)
    want = JE.pad_protocol(JP.activation_protocol(0.0, dt_ms=1.0),
                           proto.v.shape[-1] + 5000)
    np.testing.assert_array_equal(np_(padded.v), np.asarray(want.v))
    assert TE.pad_protocol(proto, 10) is proto
    ts = torch.linspace(0.0, 8000.0, 161)
    a = TE.simulate("hh", TR.HH_B06, proto, ts, TR.SYNTHETIC)
    b = TE.simulate("hh", TR.HH_B06, padded, ts, TR.SYNTHETIC)
    np.testing.assert_allclose(np_(a), np_(b), atol=1e-5)


def test_simulate_cases_matches_individual_solves_and_reference():
    """tests/test_eval.py::test_simulate_cases_matches_individual_solves:
    cases of unequal knots and grids, each against its own solve (2e-3)
    and against the reference's simulate_cases (1e-4 of the range)."""
    def cases(P, ts):
        kw = {} if P is JP else {"device": "cpu"}
        return [(P.activation_protocol(20.0, dt_ms=1.0, **kw),
                 ts(0.0, 8000.0, 161)),
                (P.atau_protocol(300.0, dt_ms=1.0, **kw),
                 ts(0.0, 5000.0, 101))]

    ct = cases(TP, lambda a, b, n: torch.linspace(a, b, n))
    cj = cases(JP, lambda a, b, n: jnp.linspace(a, b, n, dtype=jnp.float32))
    outs = TE.simulate_cases("hh", TR.HH_B06, ct, TR.SYNTHETIC)
    refs = JE.simulate_cases("hh", JR.HH_B06, cj, JR.SYNTHETIC)
    for (proto, ts), got, ref in zip(ct, outs, refs):
        own = TE.simulate("hh", TR.HH_B06, proto, ts, TR.SYNTHETIC)
        assert got.shape == own.shape
        np.testing.assert_allclose(np_(got), np_(own), atol=2e-3)
        _close_in_range(got, ref)
