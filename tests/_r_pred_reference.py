"""The JAX package's ``--pred`` MAEs of the committed r1 model on the
full-length stand-in caches (``_r_study_standins.write_r_caches``): the
numbers ``chip_smoke.py``'s phase (x) holds the port's card run against.

    JAX_PLATFORMS=cpu python3 tests/_r_pred_reference.py [REFDIR]

Writes the stand-in caches into REFDIR (a temporary directory by default),
prints JAX's float32 recovery of r1/ and r1-bad/ (``recover_measurements``
without x64: one clock over each recording) against the exact
propagator's r-gate (largest error of the range, its time, the share of
points within 1e-4), then points ``ionflux.realdata.recover_measurements``
(read at call time by ``predict_real_study``, which names the checkout's
fixed path, JAX's ``rstudies.REFDIR``) at the caches and runs
``ionflux.rstudies.predict_real_study`` for R1 on out/r1 on the CPU, the
model in float32 and the measurements recovered in float64 (under x64).
Prints the seconds the replay took, and last one JSON line {pr3, pr5,
pr4}.
"""

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]


def main(argv) -> int:
    import jax
    import jax.numpy as jnp

    import _r_study_standins as RS
    import ionflux.realdata as JR
    from ionflux import rstudies as JS
    from ionflux.models import registry as JReg

    refdir = argv[1] if len(argv) > 1 else tempfile.mkdtemp()
    fixed = JS.REFDIR
    RS.write_r_caches(refdir)
    recover = JR.recover_measurements

    for sub, c, rgate, kw in (
            ("r1", JReg.CELL5_R1, JReg.HH_CELL5_INIT, {}),
            ("r1-bad", JReg.CELL5_R1BAD, JReg.HH_R1BAD_INIT,
             dict(protocols=("pr3", "pr4"), n_points=30))):
        d = f"{refdir}/{sub}"
        got = recover(d, c, rgate, **kw)
        for name, (tl, err) in RS.recovery_errors(d, got, c, rgate).items():
            k = int(err.argmax())
            print(f"JAX float32 recovery {sub}/{name}: max {err[k]:.4e} of "
                  f"the range at {tl[k]:.1f} ms; {(err <= 1e-4).mean():.5f} "
                  f"of the points within 1e-4", flush=True)

    def moved(surface_dir, *a, **kw):
        jax.config.update("jax_enable_x64", True)
        try:
            return recover(surface_dir.replace(fixed, refdir), *a,
                           dtype=jnp.float64, **kw)
        finally:
            jax.config.update("jax_enable_x64", False)

    JR.recover_measurements = moved
    JS.REFDIR = refdir
    t = time.perf_counter()
    maes = JS.predict_real_study(JS.R1, os.path.join(ROOT, "out", "r1"))
    print(f"r1: {time.perf_counter() - t:.1f} s", flush=True)
    print(json.dumps({k: maes[k] for k in ("pr3", "pr5", "pr4")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
