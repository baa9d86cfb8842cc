"""ionflux_torch.fit.cmaes.cmaes_onchip (the device-resident CMA-ES, here
its eager CPU path) against ionflux.fit.cmaes.cmaes_onchip: the objectives
of tests/test_fit.py at that file's tolerances, the exact iteration counts
and per-chunk history of the stopping rules, and the generation updates on
one table of normals fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionflux.fit import cmaes as JC
from ionflux_torch.fit import cmaes as TC
from ionflux_torch.ops import sym_eig as TS

OPT = np.array([3e-4, 5e-2, 1e-5, 7e-2])


def _log_quadratic_j(xs):
    return jnp.sum((jnp.log(xs) - jnp.log(jnp.asarray(OPT, jnp.float32)))
                   ** 2, axis=1)


def _log_quadratic_t(xs):
    return torch.sum((torch.log(xs) - torch.log(torch.tensor(
        OPT, dtype=torch.float32))) ** 2, dim=1)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_converges_log_space(package):
    """tests/test_fit.py::test_cmaes_onchip_converges_log_space, in both."""
    fn = {"port": lambda *a, **k: TC.cmaes_onchip(*a, device="cpu", **k),
          "jax": JC.cmaes_onchip}[package]
    obj = {"port": _log_quadratic_t, "jax": _log_quadratic_j}[package]
    res = fn(obj, OPT * 3.0, 0.1 * OPT * 3.0,
             bounds=(OPT * 0.01, OPT * 100.0), seed=1)
    np.testing.assert_allclose(res.x, OPT, rtol=1e-3)
    assert res.iterations < 2000 and not res.hit_max_iterations
    assert res.evaluations == res.iterations * 8


def test_inf_sentinels_and_bounds():
    """tests/test_fit.py::test_cmaes_onchip_inf_sentinels_and_bounds."""
    opt = torch.tensor([1.0, 1.0])
    lo, hi = np.array([0.5, 0.5]), np.array([4.0, 4.0])

    def batch(xs):
        out = torch.sum((xs - opt) ** 2, dim=1)
        return torch.where(xs[:, 0] > 2.0, torch.full_like(out, np.inf), out)

    res = TC.cmaes_onchip(batch, np.array([1.5, 1.5]), 0.3, bounds=(lo, hi),
                          seed=0, max_iterations=200, device="cpu")
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=0.05)
    assert np.all(res.x >= lo) and np.all(res.x <= hi)


@pytest.mark.parametrize("rule", ["max_iterations", "unchanged"])
def test_exact_iterations_and_history_per_chunk(rule):
    """A constant objective: its first generation improves on inf, none
    after, so the unchanged rule fires after max_unchanged + 1 generations;
    max_iterations cuts at its count.  Both mid-chunk (sync_every 4): the
    reported count is exact, and history holds (iteration, best) at every
    chunk boundary from the start, as JAX's does."""
    kw = dict(seed=2, sync_every=4)
    if rule == "max_iterations":
        kw.update(max_iterations=13, max_unchanged_iterations=100)
        want_it = 13
    else:
        kw.update(max_unchanged_iterations=6)
        want_it = 7
    x0 = np.array([1.0, 2.0, 3.0])
    rt = TC.cmaes_onchip(lambda xs: torch.full((xs.shape[0],), 2.5), x0,
                         0.1, device="cpu", **kw)
    rj = JC.cmaes_onchip(lambda xs: jnp.full((xs.shape[0],), 2.5,
                                             jnp.float32), x0, 0.1, **kw)
    assert rt.iterations == rj.iterations == want_it
    assert rt.evaluations == rj.evaluations == want_it * 7
    assert rt.hit_max_iterations == rj.hit_max_iterations == (
        rule == "max_iterations")
    assert rt.history == rj.history
    assert [h[0] for h in rt.history] == list(range(0, want_it, 4)) + [
        want_it]
    assert rt.fx == 2.5


def _pairs(xs: np.ndarray):
    """Members 2k and 2k + 1 drawn with normals +e_k and -e_k: their mean
    and their half-difference's magnitude in log space, which do not depend
    on the sign an eigensolver gives eigenvector k."""
    lx = np.log(xs.astype(np.float64))
    return (0.5 * (lx[0::2] + lx[1::2]), 0.5 * np.abs(lx[0::2] - lx[1::2]))


def test_generation_updates_match_jax_on_one_table(monkeypatch):
    """Three generations on one table of normals: generation 1 random (the
    covariance is I, so both eigensolvers return I), generations 2 and 3
    +-e_k in member pairs, so their candidates show the updated mean, step
    size and eigenvalues, and the eigenvectors up to sign.  f32 in both; the
    two eigensolvers (Jacobi here, LAPACK there) agree within ~1e-6."""
    lam, n = 8, 4
    rs = np.random.RandomState(0)
    pm = np.zeros((lam, n), np.float32)
    for k in range(n):
        pm[2 * k, k], pm[2 * k + 1, k] = 1.0, -1.0
    table = np.stack([rs.randn(lam, n).astype(np.float32), pm, pm, pm])

    # the JAX package: its normals looked up by the generation's key
    keys, key = [], jax.random.PRNGKey(0)
    for _ in range(len(table)):
        key, k_z = jax.random.split(key)
        keys.append(k_z)
    keys = jnp.stack(keys)

    def normal_j(k_z, shape, dtype=jnp.float32):
        idx = jnp.argmax(jnp.all(keys == k_z[None], axis=1))
        return jnp.asarray(table, dtype)[idx]

    monkeypatch.setattr(jax.random, "normal", normal_j)
    seen_j = []

    def obj_j(xs):
        jax.debug.callback(lambda x: seen_j.append(np.asarray(x)), xs)
        return _log_quadratic_j(xs)

    # the port: its normals in draw order
    drawn = []

    def normals_t(gen, lam_, n_, device):
        drawn.append(1)
        return torch.from_numpy(table[min(len(drawn), len(table)) - 1])

    monkeypatch.setattr(TC, "_normals", normals_t)
    seen_t = []

    def obj_t(xs):
        seen_t.append(xs.numpy().copy())
        return _log_quadratic_t(xs)

    kw = dict(bounds=(OPT * 0.01, OPT * 100.0), seed=0, sync_every=1,
              max_iterations=3)
    x0 = OPT * 3.0
    rj = JC.cmaes_onchip(obj_j, x0, 0.1 * x0, **kw)
    rt = TC.cmaes_onchip(obj_t, x0, 0.1 * x0, device="cpu", **kw)
    assert rt.iterations == rj.iterations == 3
    np.testing.assert_allclose(seen_t[0], seen_j[0], rtol=1e-6)
    for g in (1, 2):
        for a, b in zip(_pairs(seen_t[g]), _pairs(seen_j[g])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rt.fx, rj.fx, rtol=1e-5)


def test_sym_eig_plain_matches_eigh():
    """K2's plain version (the CPU path of cmaes_onchip) against
    torch.linalg.eigh on random SPD matrices up to 16 x 16: eigenvalues and
    B diag(d) B^T within 1e-5 of the matrix's scale, B orthonormal."""
    rs = np.random.RandomState(0)
    for n, m in ((1, 3), (4, 200), (9, 20), (16, 10)):
        q = rs.randn(m, n, n)
        a = torch.from_numpy((q @ q.transpose(0, 2, 1)
                              + 0.1 * np.eye(n)).astype(np.float32))
        w, v = TS.sym_eig(a)
        w_ref = torch.linalg.eigh(a.double())[0].float()
        scale = a.abs().amax(dim=(-2, -1), keepdim=True)
        assert torch.all((w - w_ref).abs() <= 1e-5 * scale[..., 0])
        rec = v @ torch.diag_embed(w) @ v.transpose(-2, -1)
        assert torch.all((rec - a).abs() <= 1e-5 * scale)
        eye = v.transpose(-2, -1) @ v
        assert torch.allclose(eye, torch.eye(n).expand_as(eye), atol=1e-5)
        assert torch.all(w[..., 1:] >= w[..., :-1])
    ident = TS.sym_eig(torch.eye(4))
    assert torch.equal(ident[0], torch.ones(4))
    assert torch.equal(ident[1], torch.eye(4))
