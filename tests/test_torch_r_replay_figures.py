"""The port's r-study figure drivers (scripts/figure_4_torch.py,
figure_4_s_torch.py, figure_5_torch.py, figure_6_torch.py,
figure_supplements_torch.py) on the CPU, each against the JAX package's
helpers composed in the JAX driver's order on the same stand-ins
(``_r_replay_world`` says which, and the tolerances)."""

import os

import jax.numpy as jnp
import numpy as np

from ionflux import figures as JF
from ionflux import protocols as JP
from ionflux import studies as JSt
from ionflux.models import nn as JN
from ionflux.models import registry as JR
from ionflux.utils import ckpt as JC
from ionflux.utils.ptload import load_mlp_state_dict, pt_load

from _r_replay_world import (close, jax_meas, jax_measured_maes,  # noqa
                             jax_sim, lattice_idx, run_driver, world)


def test_figure_4_and_4_s_match_jax(world):
    """Figure 4's MAEs at the measurement's samples against JAX's Pr3 and
    Pr5; 4-s draws the same columns, here from figure 4's caches
    (--cached: the same numbers)."""
    got, outdir = run_driver(world, "figure_4_torch")
    meas = jax_meas(world["ref"])
    assert list(got) == ["pr3", "pr5"]
    for label, kind, params, c in JF.load_r_models(world["out"]):
        want = jax_measured_maes(meas, kind, params, c)[:2]
        close([got["pr3"][label], got["pr5"][label]], want)
    assert os.path.exists(os.path.join(outdir, "fig4.png"))
    got_s, _ = run_driver(world, "figure_4_s_torch", "--cached",
                          sub="figure_4_torch")
    assert got_s == got
    for f in ("fig4-s.png", "pr3.png", "pr3-z.png", "pr5.png",
              "pr3/s1.png", "pr5/s0.png"):
        assert os.path.exists(os.path.join(outdir, f)), f


def test_figure_5_matches_jax(world):
    """Pr4 (all sweeps, at the measurement's samples) and the sinewave
    and APs against the stand-in figure-5/y1 traces."""
    got, outdir = run_driver(world, "figure_5_torch")
    meas = jax_meas(world["ref"])
    tl, i_meas = meas["pr4"]
    idx = lattice_idx(tl)
    for label, kind, params, c in JF.load_r_models(world["out"]):
        want = [float(np.mean(np.abs(jax_sim(kind, params, "pr4", c)[idx]
                                     - np.asarray(i_meas))))]
        for name in ("sinewave", "aps"):
            data = np.asarray(pt_load(
                f"{world['ref']}/figure-5/y1-{name}.pt")).reshape(-1)
            want.append(float(np.mean(np.abs(
                jax_sim(kind, params, name, c) - data))))
        close([got[n][label] for n in ("pr4", "sinewave", "aps")], want)
    assert os.path.exists(os.path.join(outdir, "fig5.png"))


def test_figure_6_matches_jax(world):
    """The HH fit, the reference's r1-bad net (the stand-in state dict)
    and out/r1-bad on Pr4 and Pr5 against their measurements."""
    got, outdir = run_driver(world, "figure_6_torch")
    ref_bad = JN.NNfParams(
        net=[(jnp.asarray(w), jnp.asarray(b)) for w, b in
             load_mlp_state_dict(f"{world['ref']}/r1-bad/model-state-dict.pt")],
        rgate=JR.HH_R1BAD_INIT)
    ours = JC.load_pytree(os.path.join(world["out"], "r1-bad", "model.npz"),
                          ref_bad)
    meas = jax_meas(world["ref"])
    models = {"Original": ("hh", JR.HH_CELL5_FIT, JR.CELL5_RAW),
              "NN-f (r1-bad ref)": ("nnf", ref_bad, JR.CELL5_R1BAD),
              "NN-f (r1-bad ours)": ("nnf", ours, JR.CELL5_R1BAD)}
    for name in ("pr4", "pr5"):
        tl, i_meas = meas[name]
        idx = lattice_idx(tl)
        assert list(got[name]) == list(models)
        close([got[name][lb] for lb in models],
               [float(np.mean(np.abs(jax_sim(k, p, name, c)[idx]
                                     - np.asarray(i_meas))))
                for k, p, c in models.values()])
    assert got[name]["NN-f (r1-bad ref)"] == got[name]["NN-f (r1-bad ours)"]
    assert os.path.exists(os.path.join(outdir, "fig6.png"))


def test_figure_supplements_match_jax(world):
    """The four s-study cases' MAEs against the noiseless truth (the drawn
    noise, a torch.Generator's, enters only the figure)."""
    got, outdir = run_driver(world, "figure_supplements_torch")
    models = {"True model": ("hh", JR.HH_B06)}
    for spec, label in ((JSt.S1, "NN-f (s1)"), (JSt.S2, "NN-d (s2)")):
        models[label] = (spec.model_kind, JSt.load_study_params(
            spec, os.path.join(world["out"], spec.name)))
    cases = [
        ("pr3-20mV", JP.activation_protocol(20.0, dt_ms=1.0), 8000.0, 8001),
        ("pr5--100mV", JP.deactivation_protocol(-100.0, dt_ms=1.0),
         10000.0, 10001),
        ("ap2hz", JP.load_csv(os.path.join(world["ref"], "test-protocols",
                                           "ap2hz.csv")), 3000.0, 1501),
        ("atau-300ms", JP.atau_protocol(300.0, dt_ms=1.0), 5000.0, 5001),
    ]
    assert list(got) == [c[0] for c in cases]
    for name, proto, t_end, n in cases:
        ts = np.linspace(0.0, t_end, n)
        cache = os.path.join(world["tmp"], "jax-supp")
        truth = JF.cached_sim(cache, f"{name}-gt", False, "hh", JR.HH_B06,
                              proto, ts, JR.SYNTHETIC)
        preds = {label: JF.cached_sim(cache, f"{name}-{label}", False, kind,
                                      params, proto, ts, JR.SYNTHETIC)
                 for label, (kind, params) in models.items()}
        want = JF.mae_row(truth, preds)
        assert list(got[name]) == list(want)
        close(list(got[name].values()), list(want.values()))
    for f in ("fig-s23.png", "fig-s1.png"):
        assert os.path.exists(os.path.join(outdir, f))
