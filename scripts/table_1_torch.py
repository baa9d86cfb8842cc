#!/usr/bin/env python
"""Table 1 on the ionflux_torch port: the d-study MAEs of the d0-fitted
candidate ("Original"), NN-f (out/d1) and NN-d (out/d2) on the recorded
cell-5 protocols (``scripts/table_1.py``).

The data are the 3-state Markov ground truth plus 0.1 N(0, 1) noise drawn
from a ``torch.Generator`` seeded with the column's index, or the
reference's stored ``table-1/yc-*.pt`` traces where ``IONFLUX_REFERENCE``
holds them; the models simulate with g = 1, E = -88.4 mV; the Pr4 column
scores sweeps 1-3 only.  The multi-sweep recordings go through the
segment-chained solve.  Every trace is cached as <outdir>/<name>.npz and
``--cached`` reads them back.

    python3 scripts/table_1_torch.py [--cached] [--device cpu]

writes <outdir>/table-1.txt (default out/table-1-torch) and returns
{column: {model: MAE}}.  ``--oracle`` also tabulates the reference's
archived checkpoints (``d1/``, ``d2/model-state-dict.pt`` under
``IONFLUX_REFERENCE``; FileNotFoundError naming the file where absent)
into table-1-oracle.txt, returned under "oracle".
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common_torch import ROOT, outdir, parse, study_parser, traced  # noqa: E402

BIG = dict(max_steps=1_000_000, buffer_size=65536)

# (column, protocol name, the reference's stored noisy trace, MAE span)
COLUMNS = [
    ("Pr3", "pr3-cell5", None, slice(None)),
    ("Pr5", "pr5-cell5", None, slice(None)),
    ("Pr4", "pr4-cell5", None, "pr4"),
    ("Sinusoidal", "sinewave-cell5", "yc-sinewave.pt", slice(None)),
    ("APs", "aps-cell5", "yc-aps.pt", slice(None)),
]

CAPTION = ("d-study MAE (nA) on the reconstructed real cell-5 protocols; "
           "Pr3/Pr5 training, Pr4 (sweeps 1-3)/Sinusoidal/APs prediction")
CAPTION_ORACLE = ("reference archived checkpoints through our solver on the "
                  "reconstructed protocols (parity vs table-1/table-1.txt)")


def noisy(truth, seed: int, device) -> "np.ndarray":
    """truth + 0.1 N(0, 1), drawn from a torch.Generator seeded `seed` on
    device, in the default dtype; numpy f64."""
    import torch

    from ionflux_torch.observe import add_noise

    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.as_tensor(truth, dtype=torch.get_default_dtype(),
                        device=device)
    return add_noise(gen, y).double().cpu().numpy()


def main(argv=None) -> dict:
    parser = study_parser("Table 1: d-study MAE table on real protocols, "
                          "on the ionflux_torch port.")
    parser.add_argument("--oracle", action="store_true",
                        help="also tabulate the reference's archived "
                             "checkpoints")
    args = parse(parser, argv)
    out = outdir(args, "table-1-torch")

    import numpy as np
    import torch

    from ionflux_torch import protorec, studies
    from ionflux_torch._device import resolve_device
    from ionflux_torch.eval import simulate_long
    from ionflux_torch.figures import (cached_sim, latex_table,
                                       load_d_models,
                                       load_d_models_reference, mae_row)
    from ionflux_torch.models.registry import MARKOV_B06, TABLE1

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    def sim(cache_name, kind, params, proto_name, ts):
        path = os.path.join(out, f"{cache_name}.npz")
        if args.cached and os.path.exists(path):
            with np.load(path) as z:
                return z["y"]
        if proto_name in protorec.SWEEPS:
            y = simulate_long(kind, params, proto_name, TABLE1,
                              device=device).double().cpu().numpy()
        else:
            proto = protorec.protocol(proto_name, device=device)
            y = cached_sim(out, cache_name, False, kind, params, proto, ts,
                           TABLE1, **BIG)
        np.savez(path, y=y)
        return y

    def data_trace(col, proto_name, yc_name, ts, seed):
        yc = os.path.join(studies.REFDIR or "", "table-1", yc_name or "")
        if yc_name is not None and studies.REFDIR and os.path.exists(yc):
            trace = torch.load(yc, map_location="cpu", weights_only=False)
            return np.asarray(trace, np.float64).reshape(-1)
        truth = sim(f"{col}-gt", "markov", MARKOV_B06, proto_name, ts)
        return noisy(truth, seed, device)

    def build(models, out_name, caption):
        rows = {label: [] for label in models}
        table = {}
        for seed, (col, proto_name, yc_name, sl) in enumerate(COLUMNS):
            v, dt = protorec.load_voltage(proto_name)
            ts = np.arange(len(v)) * dt
            data = data_trace(col, proto_name, yc_name, ts, seed)
            if sl == "pr4":  # sweeps 1-3 only
                n = len(v) // 16
                sl = slice(n, 4 * n)
            preds = {
                label: sim(f"{col}-{out_name}-{label}", kind, params,
                           proto_name, ts)[sl]
                for label, (kind, params, _s) in models.items()
            }
            table[col] = mae_row(data[sl], preds)
            for label, val in table[col].items():
                rows[label].append(val)
                print(f"{col} ({label}) | Total Loss {val:.6f}")
        latex_table(os.path.join(out, out_name), [c[0] for c in COLUMNS],
                    rows, caption=caption)
        return table

    with traced(args, out):
        result = build(load_d_models(os.path.join(ROOT, "out"), device),
                       "table-1.txt", CAPTION)
        if args.oracle:
            result["oracle"] = build(
                load_d_models_reference(device=device), "table-1-oracle.txt",
                CAPTION_ORACLE)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
