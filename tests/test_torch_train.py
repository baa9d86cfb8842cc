"""Surface training (ionflux_torch/fit/train.py) against ionflux/fit/train.py
on the same nets and surfaces.

Tolerances: the loss and the pretrain and anchor grids are one f32 pass
(sums in another order): rtol 1e-5.  The loss traces of Adam runs agree to
1e-3 relative: torch's Adam and optax's take the same steps with their
bias corrections and decayed rates rounded differently (f64 host scalars
here, f32 there).  Chunks of one run in the port are equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux.fit import train as JT
from ionflux.models import registry as JR
from ionflux_torch.fit import train as TT
from ionflux_torch.models import registry as TR

from _torch_helpers import assert_close, jax_net, np_, np_net, torch_net

LOSS_RTOL = 1e-5
TRACE_RTOL = 1e-3


def _surface(n=256, seed=0):
    """(x [n, 2] = (V/100, a), y [n], residual [n]) in f32: the analytic
    d-study a-gate surface plus noise, and the NN-d analytic part."""
    rs = np.random.RandomState(seed)
    v = rs.uniform(-120.0, 40.0, n)
    a = rs.uniform(0.02, 0.98, n)
    p = JR.HH_D_PRETRAIN
    k1 = float(p.p1) * np.exp(float(p.p2) * v)
    k2 = float(p.p3) * np.exp(-float(p.p4) * v)
    y = k1 * (1 - a) - k2 * a + 1e-4 * rs.randn(n)
    b = JR.HH_D2_BASE
    res = (float(b.p1) * np.exp(float(b.p2) * v) * (1 - a)
           - float(b.p3) * np.exp(-float(b.p4) * v) * a)
    x = np.stack([v / 100.0, a], axis=-1)
    return [z.astype(np.float32) for z in (x, y, res)]


def _both(*arrays):
    return ([jnp.asarray(z, jnp.float32) for z in arrays],
            [torch.from_numpy(z) for z in arrays])


@pytest.mark.parametrize("residual", [False, True])
def test_surface_loss_matches(residual):
    net = np_net(0, n_layers=1, n_nodes=16)
    x, y, res = _surface()
    anchors = JT.boundary_anchors(None, weight=0.5)
    anchors_t = TT.boundary_anchors(None, weight=0.5, device="cpu")
    (jx, jy, jr), (tx, ty, tr) = _both(x, y, res)
    got = TT.surface_loss(torch_net(net), tx, ty, tr if residual else None,
                          anchors_t)
    want = JT.surface_loss(jax_net(net), jx, jy, jr if residual else None,
                           anchors)
    assert_close(got, want, atol=0.0, rtol=LOSS_RTOL)


def test_fit_chunk_trace_matches():
    """50 updates of a 2-16-16-1 NN-d net from weights copied out of JAX,
    with the rate decayed every 10 updates: the loss trace within 1e-3
    relative, the trained weights close."""
    net = np_net(1, n_layers=1, n_nodes=16)
    x, y, res = _surface(seed=1)
    (jx, jy, jr), (tx, ty, tr) = _both(x, y, res)
    kw = dict(iters=50, lr=1e-2, step_size=10, gamma=0.5)
    jnet, _, jl = JT.fit_chunk(jax_net(net), JT.init_opt_state(
        jax_net(net), 1e-2, 10, 0.5), jx, jy, jr, **kw)
    tnet, state, tl = TT.fit_chunk(torch_net(net), TT.init_opt_state(
        torch_net(net), 1e-2, 10, 0.5), tx, ty, tr, **kw)
    assert tl.shape == (50,) and state.count == 50
    assert float(tl[-1]) < 0.5 * float(tl[0])      # it trains
    assert_close(tl, jl, atol=0.0, rtol=TRACE_RTOL)
    for (w, _), (wj, _) in zip(tnet.layers, jnet):
        assert_close(w, wj, atol=1e-4)


def test_chunks_resume_exactly():
    """Three chunks of 17, 17 and 16 updates, each resuming from the last
    one's state, equal one chunk of 50 bit for bit (weights and losses)."""
    net = torch_net(np_net(2, n_layers=1, n_nodes=16))
    x, y, res = [torch.from_numpy(z) for z in _surface(seed=2)]
    kw = dict(lr=1e-2, step_size=10, gamma=0.5)
    one, _, l_one = TT.fit_chunk(net, TT.init_opt_state(net), x, y, res,
                                 iters=50, **kw)
    cur, state, parts = net, TT.init_opt_state(net), []
    for n in (17, 17, 16):
        cur, state, losses = TT.fit_chunk(cur, state, x, y, res, iters=n,
                                          **kw)
        parts.append(losses)
    assert state.count == 50
    assert torch.equal(torch.cat(parts), l_one)
    for (a, b), (c, d) in zip(cur.layers, one.layers):
        assert torch.equal(a, c) and torch.equal(b, d)
    # the inputs were not changed
    assert np.array_equal(np_(net[0][0]), np_net(2, 1, 16)[0][0])


@pytest.mark.parametrize("grid", ["s", "r"])
def test_pretrain_grids_match(grid):
    fn = f"pretrain_grid_{grid}"
    gx, gy = getattr(TT, fn)(TR.HH_D_PRETRAIN, 20, device="cpu")
    wx, wy = getattr(JT, fn)(JR.HH_D_PRETRAIN, 20)
    assert_close(gx, wx, atol=1e-6)
    assert_close(gy, wy, atol=1e-9, rtol=LOSS_RTOL)


def test_pretrain_matches():
    """Twenty constant-rate pretrain updates towards the d-study surface."""
    net = np_net(3, n_layers=1, n_nodes=16)
    got = TT.pretrain(torch_net(net), TR.HH_D_PRETRAIN, iters=20)
    want = JT.pretrain(jax_net(net), JR.HH_D_PRETRAIN, iters=20)
    assert isinstance(got.params, torch.nn.Module)
    assert_close(got.losses, want.losses, atol=0.0, rtol=TRACE_RTOL)


@pytest.mark.parametrize("base", [None, "d1"])
def test_boundary_anchors_match(base):
    hh = None if base is None else (TR.HH_D_PRETRAIN, JR.HH_D_PRETRAIN)
    gx, gy, gw = TT.boundary_anchors(hh and hh[0], weight=0.3, device="cpu")
    wx, wy, ww = JT.boundary_anchors(hh and hh[1], weight=0.3)
    assert_close(gx, wx, atol=1e-6)
    assert_close(gy, wy, atol=1e-9, rtol=LOSS_RTOL)
    assert float(gw) == pytest.approx(float(ww))
