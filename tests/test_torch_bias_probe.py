"""The port's Mosaic bias-broadcast probe (ops/bias_probe.py and
scripts/probe_mosaic_bias_fault_torch.py) against the Pallas kernel of
scripts/probe_mosaic_bias_fault.py run with interpret=True.

That script cannot be imported here: it sets a compilation-cache directory
when imported and has no interpret switch.  ``_reference`` below re-states
its kernel body (scripts/probe_mosaic_bias_fault.py:42-64) and its
``pallas_call`` (:66-73) without the TPU memory-space and compiler
parameters, which interpret mode does not use.  Both sides compute in f32;
64 trips of a contracting tanh update agree to 1e-6."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ionflux_torch.ops import bias_probe as TB

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import probe_mosaic_bias_fault_torch as S  # noqa: E402

TOL = 1e-6
P, Q, M, TRIPS = 64, 16, 16, 64     # the JAX script's shapes


def _reference(case: str, w, b):
    def kernel(w_ref, b_ref, o_ref):
        def body(i, acc):                               # acc [P, Q]
            if case == "fold":
                x = jnp.stack([acc, 1.0 - acc, jnp.ones_like(acc)],
                              axis=-1)                  # [P, Q, 3]
                wb = jnp.concatenate(
                    [w_ref[...][:, :2, :], b_ref[...][:, None, :]],
                    axis=1)                             # [P, 3, M]
                h = jax.lax.dot_general(
                    x, wb, (((2,), (1,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32)
            else:
                x = jnp.stack([acc, 1.0 - acc], axis=-1)
                h = jax.lax.dot_general(
                    x, w_ref[...][:, :2, :], (((2,), (1,)), ((0,), (0,))),
                    preferred_element_type=jnp.float32)  # [P, Q, M]
                h = h + b_ref[...][:, None, :]
            return jnp.tanh(h[:, :, 0] + 1e-3 * acc)

        acc = jax.lax.fori_loop(
            0, TRIPS, body, jnp.full((P, Q), 0.1, jnp.float32))
        o_ref[...] = jnp.concatenate(
            [acc, jnp.zeros((P, 128 - Q), jnp.float32)], axis=1)

    f = pl.pallas_call(kernel,
                       out_shape=jax.ShapeDtypeStruct((P, 128), jnp.float32),
                       interpret=True)
    return np.asarray(f(jnp.asarray(w, jnp.float32),
                        jnp.asarray(b, jnp.float32)))


def test_probe_constants_and_inputs_match_the_script():
    assert (S.P, TB.ROWS, S.M, TB.TRIPS, TB.OUT_COLS) == (P, Q, M, TRIPS, 128)
    w, b = S.probe_inputs("cpu")
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        w.numpy(), (rng.randn(P, 3, M) * 0.1).astype(np.float32))
    np.testing.assert_array_equal(
        b.numpy(), (rng.randn(P, M) * 0.1).astype(np.float32))


@pytest.mark.parametrize("case", ["bias", "fold"])
def test_probe_plain_matches_pallas_interpret(case):
    w, b = S.probe_inputs("cpu")
    ref = _reference(case, w.numpy(), b.numpy())
    before = TB.bias_probe.launches
    out = S.main(case, device="cpu")
    assert TB.bias_probe.launches == before    # CPU: the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == (P, 128)
    assert bool(torch.isfinite(out).all())
    assert bool((out[:, Q:] == 0).all()) and bool((out[:, :Q] != 0).all())
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    other = TB.bias_probe_plain(w, b, fold=case == "bias")
    np.testing.assert_allclose(out.numpy(), other.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("bad", ["f64 w", "w rows", "b shape", "f64 b"])
def test_probe_refuses_bad_inputs(bad):
    w, b = S.probe_inputs("cpu")
    if bad == "f64 w":
        w = w.double()
    elif bad == "w rows":
        w = w[:, :2]
    elif bad == "b shape":
        b = b[:-1]
    else:
        b = b.double()
    with pytest.raises((TypeError, ValueError)):
        TB.bias_probe(w, b)
