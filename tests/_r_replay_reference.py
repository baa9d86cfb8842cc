"""The JAX package's table 2 of the committed models (out/r1, out/r2 and
the cell-5 HH fit) on the full-length stand-in checkout: the numbers
``chip_smoke.py``'s phase (y) holds the port's card run of
``scripts/table_2_torch.py`` against.

    JAX_PLATFORMS=cpu python3 tests/_r_replay_reference.py [REFDIR]

Writes the stand-in caches (``_r_study_standins.write_r_caches``) and the
replay files (``_r_replay_standins.write_replay_files``) into REFDIR (a
temporary directory by default), then composes the JAX helpers that
``scripts/table_2.py`` calls, in its order, on the CPU: the measurements
recovered in float64 (under x64; JAX's float32 one-clock recovery leaves
a few late points up to 6e-2 of the range off, a stated difference of the
port's), the models by ``figures.load_r_models``, each simulated in
float32 by ``eval.simulate_long`` / ``solve_states_real``.  Prints the
seconds and last one JSON line {label: [Pr3, Pr5, Pr4, Sinusoidal, APs]}.
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
    import numpy as np

    import _r_replay_standins as RR
    import _r_study_standins as RS
    from ionflux import eval as JE
    from ionflux import protorec as JRec
    from ionflux.figures import load_r_models
    from ionflux.models import registry as JR
    from ionflux.observe import gate_current
    from ionflux.realdata import recover_measurements
    from ionflux.utils.ptload import pt_load

    refdir = argv[1] if len(argv) > 1 else tempfile.mkdtemp()
    t = time.perf_counter()
    RS.write_r_caches(refdir)
    RR.write_replay_files(refdir)
    print(f"stand-ins: {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = jnp.float64
        m35 = recover_measurements(f"{refdir}/r1", JR.CELL5_R1,
                                   JR.HH_CELL5_INIT, dtype=f64)
        m4 = recover_measurements(f"{refdir}/r1-bad", JR.CELL5_R1BAD,
                                  JR.HH_R1BAD_INIT, protocols=("pr3", "pr4"),
                                  n_points=30, dtype=f64)
    finally:
        jax.config.update("jax_enable_x64", False)
    meas = {"pr3": m35["pr3"], "pr5": m35["pr5"], "pr4": m4["pr4"]}
    print(f"recoveries: {time.perf_counter() - t:.1f} s", flush=True)

    tags = {"Original": "yo", "NN-f": "y1", "NN-d": "y2"}
    rows = {}
    for label, kind, params, c in load_r_models(os.path.join(ROOT, "out")):
        t = time.perf_counter()
        vals = []
        for name in ("pr3", "pr5", "pr4"):
            tl, i_meas = meas[name]
            idx = np.round(np.asarray(tl) / JRec.DT_MS).astype(np.int64)
            i_meas = np.asarray(i_meas)
            i = np.asarray(JE.simulate_long(kind, params, f"{name}-cell5", c),
                           np.float64)
            if name == "pr4":   # sweeps 1-3
                n = JRec.PR4_N // 16
                keep = (idx >= n) & (idx < 4 * n)
                idx, i_meas = idx[keep], i_meas[keep]
            vals.append(float(np.mean(np.abs(i[idx] - i_meas))))
        for name in ("sinewave", "aps"):
            ref_i = np.asarray(pt_load(
                f"{refdir}/table-2/{tags[label]}-{name}.pt")).reshape(-1)
            v, _ = JRec.load_voltage(f"{name}-cell5")
            i = gate_current(JE.solve_states_real(kind, params,
                                                  f"{name}-cell5"),
                             jnp.asarray(v, jnp.float32), c)
            vals.append(float(np.mean(np.abs(np.asarray(i, np.float64)
                                             - ref_i))))
        rows[label] = vals
        print(f"{label}: {time.perf_counter() - t:.1f} s {vals}", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
