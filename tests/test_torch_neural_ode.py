"""scripts/train_neural_ode_torch.py (neural-ODE training through the solve)
against scripts/train_neural_ode.py's JAX step, and the NN-f weights
carried across both ways.

The script runs at its own sizes on the CPU (the 2-200x5-1 NN-f, 301
output times to 3000 ms, RK4 with 8 substeps: 9,600 single-row
evaluations a pass).  ``add_noise`` draws from a torch.Generator in the
port and from jax.random in JAX, so the JAX side takes the port's noisy
data and initial net.  Bounds: the first Adam update's loss within 1e-4
relative, the updated leaves within 1e-4 of each leaf's largest entry (an
update moves a weight by ~3e-4, the rate); RK4 solves against JAX 1e-5
relative.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ionflux import protocols as JP
from ionflux.models import nnf_rhs as j_nnf_rhs
from ionflux.models.nn import NNfParams as J_NNfParams
from ionflux.models.registry import HH_B06 as J_HH_B06
from ionflux.models.registry import SYNTHETIC as J_SYN
from ionflux.observe import gate_current as j_gate_current
from ionflux.solver import odeint_adjoint as j_adj
from ionflux.solver import odeint_rk4 as j_rk4
from ionflux.utils.ckpt import load_pytree as j_load_pytree
from ionflux_torch import protocols as TP
from ionflux_torch.models.nn import MLP, NNfParams
from ionflux_torch.models.registry import HH_B06 as T_HH_B06
from ionflux_torch.utils.ckpt import load_pytree, save_pytree

from _torch_helpers import jax_net, np_, np_net, torch_net

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import train_neural_ode_torch as T  # noqa: E402

STEP_RTOL = 1e-4
RK4_RTOL = 1e-5


def j_rhs(t, y, args):
    net, proto = args
    return j_nnf_rhs(J_NNfParams(net, J_HH_B06), t, y, JP.voltage(proto, t))


def _j_step(net, proto, ts, y0, data, adjoint):
    """JAX's scripts/train_neural_ode.py update on the given inputs: (loss,
    updated leaves)."""
    v_t = JP.voltage(proto, ts)

    def loss_fn(n):
        if adjoint:
            ys = j_adj(j_rhs, y0, ts, (n, proto), 1e-4, 1e-6)
        else:
            ys = j_rk4(j_rhs, y0, ts, (n, proto), n_sub=8)
        return jnp.mean((j_gate_current(ys, v_t, J_SYN) - data) ** 2)

    opt = optax.adam(3e-4)
    loss, g = jax.value_and_grad(loss_fn)(net)
    updates, _ = opt.update(g, opt.init(net), net)
    return float(loss), jax.tree.leaves(optax.apply_updates(net, updates))


def _check_step(loss_t, first_t, loss_j, leaves_j):
    assert abs(loss_t - loss_j) <= STEP_RTOL * abs(loss_j), (loss_t, loss_j)
    for a, b in zip([x for pair in first_t for x in pair], leaves_j):
        a, b = np_(a).astype(np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=STEP_RTOL * np.abs(b).max())


def test_train_neural_ode_rk4_first_step_matches_jax(tmp_path):
    """``main(--protocol act --device cpu --iters 2)``: finite losses, a
    finite final MAE, model.npz in JAX's 22-leaf layout (JAX's load_pytree
    reads it); the first Adam update against JAX's on the port's initial
    net and noisy data."""
    run = T.main(["--protocol", "act", "--device", "cpu", "--iters", "2",
                  "--outdir", str(tmp_path)])
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert np.isfinite(run.final_mae)
    path = os.path.join(tmp_path, "model.npz")
    with np.load(path) as z:
        assert sorted(z.files) == sorted(f"leaf_{i}" for i in range(22))
    tree = j_load_pytree(path, J_NNfParams(jax_net(np_net(0, 5, 200)),
                                           J_HH_B06))
    np.testing.assert_array_equal(np.asarray(tree.net[0][0]),
                                  np_(run.params.net.layers[0][0]))

    ts = np_(torch.linspace(0.0, 3000.0, 301))
    net = [(jnp.asarray(np_(w)), jnp.asarray(np_(b))) for w, b in run.init]
    loss_j, leaves_j = _j_step(net, JP.activation_protocol(20.0, dt_ms=1.0),
                               jnp.asarray(ts),
                               jnp.asarray([0.0, 1.0], jnp.float32),
                               jnp.asarray(np_(run.data)), adjoint=False)
    _check_step(run.losses[0], run.first, loss_j, leaves_j)


def test_train_neural_ode_adjoint_step_matches_jax():
    """The script's adjoint-mode update (``Trainer(adjoint=True)``) on the
    full-width net over a 500 ms window (6 output times) against JAX's
    adjoint update on the same net and data."""
    net = np_net(5, n_layers=5, n_nodes=200)
    ts = np.linspace(0.0, 500.0, 6).astype(np.float32)
    rs = np.random.RandomState(0)
    data = (0.5 + 0.1 * rs.randn(6)).astype(np.float32)
    tp = TP.activation_protocol(20.0, dt_ms=1.0, device="cpu")
    y0 = torch.tensor([0.0, 1.0])
    tr = T.Trainer(torch_net(net), tp, torch.from_numpy(ts), y0,
                   torch.from_numpy(data), adjoint=True)
    loss_t = float(tr.step())
    loss_j, leaves_j = _j_step(jax_net(net),
                               JP.activation_protocol(20.0, dt_ms=1.0),
                               jnp.asarray(ts),
                               jnp.asarray([0.0, 1.0], jnp.float32),
                               jnp.asarray(data), adjoint=True)
    _check_step(loss_t, tr.net, loss_j, leaves_j)


def test_carried_model_through_rk4_matches_jax():
    """JAX's trained out/neural-ode/model.npz through the port's
    ``load_pytree`` and RK4 solve (the script's solver, activation
    protocol, 301 output times) against JAX's RK4 solve of the same net:
    1e-5 relative."""
    path = os.path.join(ROOT, "out", "neural-ode", "model.npz")
    params = load_pytree(path, "nnf", device="cpu")
    tp = TP.activation_protocol(20.0, dt_ms=1.0, device="cpu")
    ts = torch.linspace(0.0, 3000.0, 301)
    with torch.no_grad():
        ys = T.solve(params.net.layers, tp, ts, torch.tensor([0.0, 1.0]),
                     adjoint=False)
    tree = j_load_pytree(path, J_NNfParams(jax_net(np_net(0, 5, 200)),
                                           J_HH_B06))
    yj = j_rk4(j_rhs, jnp.asarray([0.0, 1.0], jnp.float32),
               jnp.asarray(np_(ts)),
               (tree.net, JP.activation_protocol(20.0, dt_ms=1.0)), n_sub=8)
    a, b = np_(ys).astype(np.float64), np.asarray(yj, np.float64)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=RK4_RTOL, atol=1e-7)


def test_save_pytree_reads_back_in_jax(tmp_path):
    """The port's model.npz layout through JAX's load_pytree: every leaf
    bit for bit, the r-gate's eight scalars last."""
    net = np_net(2, n_layers=2, n_nodes=8)
    path = os.path.join(tmp_path, "model.npz")
    save_pytree(path, NNfParams(MLP(torch_net(net)), T_HH_B06))
    tree = j_load_pytree(path, J_NNfParams(jax_net(net), J_HH_B06))
    for (w, b), (wj, bj) in zip(net, tree.net):
        np.testing.assert_array_equal(w, np.asarray(wj))
        np.testing.assert_array_equal(b, np.asarray(bj))
    np.testing.assert_array_equal(
        [float(x) for x in tree.rgate], [float(x) for x in T_HH_B06])


def test_ap2hz_without_the_reference_fails_naming_the_file(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(T, "REFDIR", None)
    with pytest.raises(FileNotFoundError, match="ap2hz.csv"):
        T.main(["--device", "cpu", "--iters", "1", "--outdir",
                str(tmp_path)])
