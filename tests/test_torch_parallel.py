"""ionflux_torch.parallel at world size 1 (one process, no process group)
against ionflux.parallel on one device, the sharded entry points' checks,
and their single-process results against the unsharded ones.  The
multi-process runs are in test_torch_multiproc.py."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux import eval as JE
from ionflux import parallel as JPar
from ionflux.fit import cmaes as JC
from ionflux_torch import eval as TE
from ionflux_torch import parallel as TPar
from ionflux_torch import protocols as TP
from ionflux_torch.fit import cmaes as TC
from ionflux_torch.models import nn as TN
from ionflux_torch.models import registry as TR

import _multiproc_workers as W
from _torch_helpers import np_, np_net, torch_family, torch_net, \
    ts_between_edges

CPU = torch.device("cpu")


def two_rank_mesh():
    """A mesh that claims two ranks, for the checks that raise before any
    collective (no process group is started)."""
    return TPar.Mesh(np.arange(2), ("pop",), CPU, {"pop": None})


def test_same_names_and_signatures_as_jax():
    for name in JPar.__all__:
        t, j = getattr(TPar, name), getattr(JPar, name)
        pt = inspect.signature(t).parameters
        pj = inspect.signature(j).parameters
        # the port's additions come last, with defaults: the device, the
        # gather's dim/axis, the backend in place of local_cpu_devices
        assert list(pt)[:len(pj) - (name == "init_multihost")] == list(
            pj)[:len(pj) - (name == "init_multihost")], name
    for mod_t, mod_j, name in ((TE, JE, "simulate_population_sharded"),
                               (TC, JC, "shard_objective")):
        assert (list(inspect.signature(getattr(mod_t, name)).parameters)
                == list(inspect.signature(getattr(mod_j, name)).parameters))


def test_mesh_helpers_at_world_size_one_match_jax():
    """One rank: the mesh's shape, the shard (the whole), the replica and
    sharded_map (fn itself) against JAX's on one device."""
    mesh = TPar.make_mesh(axes=("pop", "data"), device="cpu")
    jmesh = JPar.make_mesh(1, ("pop", "data"))
    assert mesh.shape == dict(jmesh.shape) == {"pop": 1, "data": 1}
    assert mesh.devices.shape == jmesh.devices.shape
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    got = TPar.shard_along(mesh, "pop", torch.from_numpy(x))
    want = JPar.shard_along(jmesh, "pop", jnp.asarray(x))
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    net = TN.MLP(torch_net(np_net(1)))
    rep = TPar.replicate(mesh, {"net": net, "w": torch.ones(3)})
    assert [np_(w).tolist() for w, _ in rep["net"].layers] == [
        np_(w).tolist() for w, _ in net.layers]

    def per_shard(xs):
        return xs ** 2 + 1.0

    f = TPar.sharded_map(mesh, "pop", per_shard)
    assert f is per_shard
    with jmesh:
        want = JPar.sharded_map(jmesh, "pop", per_shard)(jnp.asarray(x))
    np.testing.assert_array_equal(np_(f(torch.from_numpy(x))),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="needs as many processes"):
        TPar.make_mesh(2, ("pop",), device="cpu")
    with pytest.raises(ValueError, match="does not hold"):
        TPar.make_mesh(None, ("pop", "data"), (1, 2), device="cpu")


@pytest.mark.parametrize("shape, m, axis", [((10, 1), 8, 0), ((8, 3), 4, 0),
                                            ((3, 5, 2), 4, 1), ((7,), 3, 0)])
def test_pad_to_multiple_bit_for_bit(shape, m, axis):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, n = TPar.pad_to_multiple(x, m, axis)
    want, nj = JPar.pad_to_multiple(x, m, axis)
    assert n == nj == shape[axis]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_init_multihost_needs_its_arguments(monkeypatch):
    for name in ("IONFLUX_COORDINATOR", "IONFLUX_NUM_PROCS",
                 "IONFLUX_PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="IONFLUX_COORDINATOR"):
        TPar.init_multihost()
    assert TPar.multihost.choose_backend(2) == "gloo"   # no card here


@pytest.mark.parametrize("form", ["batch", "member"])
def test_shard_objective_one_process_matches_jax(form):
    """One rank against JAX's on one device: the lockstep objective of
    tests/test_multihost.py, 7 members padded to popsize 4's multiple,
    float64 losses cut to 7.  Tolerance: the two f32 lockstep solves at
    rtol 1e-5 (test_torch_batched.py holds such gates to 3e-5 off the
    edges; these 400 ms have none), on an SSE of 9 points, 1e-6."""
    xs = np.linspace(0.8, 1.2, 28, dtype=np.float32).reshape(7, 4)
    mesh = TPar.make_mesh(axes=("pop",), device="cpu")
    kw = ({"batch_fn": W.batch_objective} if form == "batch"
          else {"per_member_fn": W.member_objective})
    got = TC.shard_objective(mesh, popsize=4, n_params=4, **kw)(xs)
    assert got.dtype == np.float64 and got.shape == (7,)
    jkw = ({"batch_fn": jax_batch_objective} if form == "batch"
           else {"per_member_fn": lambda x: jax_batch_objective(x[None])[0]})
    want = JC.shard_objective(JPar.make_mesh(1, ("pop",)), popsize=4,
                              n_params=4, **jkw)(xs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="exactly one"):
        TC.shard_objective(mesh, popsize=4)
    with pytest.raises(ValueError, match="must divide"):
        TC.shard_objective(two_rank_mesh(), batch_fn=W.batch_objective,
                           popsize=3)


def jax_batch_objective(xs):
    """W.batch_objective in the JAX package (tests/test_multihost.py's)."""
    from ionflux import protocols as JP
    from ionflux.models.registry import HH_B06
    from ionflux.solver import odeint_batched

    proto = JP.activation_protocol(20.0, dt_ms=1.0)

    def rhs(t, y, scale):
        v = JP.voltage(proto, t)
        k1 = scale[:, 0] * HH_B06.p1 * jnp.exp(HH_B06.p2 * v)
        k2 = scale[:, 1] * HH_B06.p3 * jnp.exp(-HH_B06.p4 * v)
        k3 = scale[:, 2] * HH_B06.p5 * jnp.exp(HH_B06.p6 * v)
        k4 = scale[:, 3] * HH_B06.p7 * jnp.exp(-HH_B06.p8 * v)
        dadt = k1 * (1 - y[:, 0]) - k2 * y[:, 0]
        drdt = -k3 * y[:, 1] + k4 * (1 - y[:, 1])
        return jnp.stack([dadt, drdt], axis=-1)

    y0 = jnp.tile(jnp.array([0.0, 1.0], jnp.float32), (xs.shape[0], 1))
    ys = odeint_batched(rhs, y0, jnp.asarray(W.OBJ_TS), xs, rtol=1e-5,
                        atol=1e-7, buffer_size=512)
    return jnp.sum((ys[:, :, 0] * ys[:, :, 1] - 0.5) ** 2, axis=-1)


def test_simulate_population_sharded_one_rank_is_simulate_population():
    """mesh=None is this process alone: the same launch as
    simulate_population, bit for bit; a population that does not divide
    over the axis raises, as JAX's does."""
    net = np_net(7, members=2, n_nodes=8)
    pt = torch_family(TP.activation_protocol, (-40.0, 20.0))
    ts = torch.from_numpy(np.concatenate(
        [[0.0], np_(ts_between_edges(step=400.0)[1])]).astype(np.float32))
    pop = TN.NNfParams(TN.MLP(torch_net(net)), TR.HH_B06)
    got = TE.simulate_population_sharded("nnf", pop, pt, ts, TR.SYNTHETIC,
                                         trips=1024)
    want = TE.simulate_population("nnf", pop, pt, ts, TR.SYNTHETIC,
                                  trips=1024)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    with pytest.raises(ValueError, match="does not divide"):
        TE.simulate_population_sharded(
            "nnf", TN.NNfParams(TN.MLP(torch_net(np_net(7, members=3))),
                                TR.HH_B06), pt, ts, TR.SYNTHETIC,
            mesh=two_rank_mesh(), trips=256)
