"""One model on the long recordings: eval.solve_states_long / simulate_long
(the per-sweep chained solve) on the 16-sweep Pr4 recording and
solve_states_real on the single-segment sinewave, HH at HH_B06, against
ionflux.  Two adaptive f32 solves whose step sequences part at round-off
(XLA:CPU contracts multiply-adds into FMAs and rounds exp differently):
their gates agree to ~1e-3 in the few steps around the protocols' voltage
edges and to ~1e-6 (the median) elsewhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import eval as JE
from ionflux.models import registry as JR
from ionflux_torch import eval as TE
from ionflux_torch import protorec as TRec
from ionflux_torch.models import registry as TR

from _torch_helpers import np_

GATE_MAX = 2.5e-3    # anywhere, edges included
GATE_MEDIAN = 1e-5   # half the samples


def _assert_gates_close(port, ref):
    d = np.abs(np_(port).astype(np.float64) - np.asarray(ref, np.float64))
    assert np.isfinite(d).all()
    assert d.max() <= GATE_MAX and np.median(d) <= GATE_MEDIAN, (
        d.max(), np.median(d))


@pytest.mark.parametrize("name", ["pr4-cell5", "sinewave-cell5"])
def test_solve_states_real_matches_reference(name):
    """pr4-cell5 through solve_states_long (16 sweeps of 29,006 samples, one
    local clock each, one-sample overlap), sinewave-cell5 through one
    adaptive solve of 80,000 samples (max_steps 400,000, buffer 32,768)."""
    ys = TE.solve_states_real("hh", TR.HH_B06, name, device="cpu")
    want = JE.solve_states_real("hh", JR.HH_B06, name, dtype=jnp.float32)
    n = len(TRec.load_voltage(name)[0])
    assert tuple(ys.shape) == (n, 2) and ys.dtype == torch.float32
    _assert_gates_close(ys, want)


def test_simulate_long_matches_reference():
    """The Pr4 current at TABLE1's reversal, against the reference's, to
    GATE_MAX times the largest |V - E|; and the recording's own voltage
    times the chained solve's gates."""
    cur = TE.simulate_long("hh", TR.HH_B06, "pr4-cell5", TR.TABLE1,
                           device="cpu")
    want = np.asarray(JE.simulate_long("hh", JR.HH_B06, "pr4-cell5",
                                       JR.TABLE1))
    v, _ = TRec.load_voltage("pr4-cell5")
    assert tuple(cur.shape) == v.shape and cur.dtype == torch.float32
    scale = float(np.abs(v - float(TR.TABLE1.e)).max())
    np.testing.assert_allclose(np_(cur), want, rtol=0, atol=GATE_MAX * scale)


def test_long_solves_follow_their_inputs_device():
    """No tensor argument: the device keyword decides, and a y0 tensor's
    device wins over the default; the wrong kind of recording is refused."""
    y0 = torch.tensor([0.0, 1.0])
    a = TE.solve_states_real("hh", TR.HH_B06, "sinewave-cell5", y0=y0,
                             max_steps=10, buffer_size=16)
    assert a.device == y0.device and bool(torch.isinf(a).all())
    with pytest.raises(KeyError):
        TE.solve_states_long("hh", TR.HH_B06, "sinewave-cell5",
                             device="cpu")
