"""Figure and table replay helpers (counterpart of ``ionflux/figures.py``:
what the d-, s- and r-study drivers call).

The drivers (``scripts/table_*_torch.py``, ``figure_*_torch.py``) simulate
the ground truth and each model per protocol, cache the traces as npz, and
lay out multi-panel comparisons with zoom panels.  The numeric helpers
(``load_d_models``, ``load_d_models_reference``, ``load_s_models``,
``load_r_models``, ``cached_sim``, ``mae_row``, ``latex_table``,
``dense_measurement``, the style tables) need no plotting library;
matplotlib is imported inside the plotting functions only, and one of them
called without it raises ``ImportError``.  The reference's archived
weights are read from ``IONFLUX_REFERENCE`` when a loader runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ionflux_torch import protocols as P
from ionflux_torch._device import resolve_device
from ionflux_torch.eval import simulate
from ionflux_torch.models.registry import Constants
from ionflux_torch.observe import mae


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or an ImportError that says
    what needs it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            "ionflux_torch.figures: drawing a figure needs matplotlib, which "
            "is not installed; the numeric helpers (load_d_models, "
            "load_s_models, cached_sim, mae_row, latex_table) work without "
            "it") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_d_models(out_root: str, device=None) -> dict:
    """The d-study trio {label: (kind, params, style)}: the d0-fitted
    candidate ("Original") and the trained NN-f (d1) and NN-d (d2) under
    out_root, where their model.npz exists."""
    from ionflux_torch.models.registry import HH_D0_FIT
    from ionflux_torch.studies import D1, D2, load_study_params

    models = {"Original": ("hh", HH_D0_FIT, "C2--")}
    for spec, label, style in [(D1, "NN-f", "C0--"), (D2, "NN-d", "C1--")]:
        d = os.path.join(out_root, spec.name)
        if os.path.exists(os.path.join(d, "model.npz")):
            models[label] = (spec.model_kind,
                             load_study_params(spec, d, device), style)
        else:
            print(f"{label}: {d}/model.npz missing; run "
                  f"scripts/train_{spec.name}_torch.py first")
    return models


def _reference_file(refdir: str | None, rel: str) -> str:
    """The path of ``rel`` in the reference checkout ``refdir`` (default
    ``IONFLUX_REFERENCE``, read now); FileNotFoundError naming the file
    where it is absent."""
    if refdir is None:
        from ionflux_torch.studies import REFDIR as refdir
    path = os.path.join(refdir or "", rel)
    if not refdir or not os.path.exists(path):
        raise FileNotFoundError(
            f"the reference's {rel} is not there (IONFLUX_REFERENCE="
            f"{refdir!r})")
    return path


def _reference_net(path: str, device, key: str | None = None):
    """An MLP from a reference state dict (keys net.<i>.weight [out, in],
    net.<i>.bias), or from the dict under ``key`` of a checkpoint."""
    from ionflux_torch.models.nn import MLP

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None:
        sd = sd[key]
    idxs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("net.")})
    dev = resolve_device(device)
    return MLP([(torch.as_tensor(np.ascontiguousarray(
        np.asarray(sd[f"net.{i}.weight"]).T), dtype=torch.float32,
        device=dev), torch.as_tensor(np.asarray(sd[f"net.{i}.bias"]),
                                     dtype=torch.float32, device=dev))
        for i in idxs])


def load_d_models_reference(refdir: str | None = None, device=None) -> dict:
    """The d-study trio {label: (kind, params, style)} from the reference's
    archived state dicts (``d1/``, ``d2/model-state-dict.pt`` under refdir,
    default ``IONFLUX_REFERENCE``): the d0-fitted candidate, NN-f on d0's
    initial r-gate, NN-d on HH_D2_BASE.  FileNotFoundError naming the file
    where one is absent."""
    from ionflux_torch.models.nn import NNdParams, NNfParams
    from ionflux_torch.models.registry import (HH_D0_FIT, HH_D0_INIT,
                                               HH_D2_BASE)

    def net(study):
        return _reference_net(_reference_file(
            refdir, f"{study}/model-state-dict.pt"), device)

    return {
        "Original": ("hh", HH_D0_FIT, "C2--"),
        "NN-f": ("nnf", NNfParams(net=net("d1"), rgate=HH_D0_INIT), "C0--"),
        "NN-d": ("nnd", NNdParams(net=net("d2"), hh=HH_D2_BASE), "C1--"),
    }


def load_s_models(out_root: str | None = None, refdir: str | None = None,
                  device=None) -> dict:
    """The s-study trio {label: (kind, params, style)}: the candidate HH
    (the s-studies' ground truth) and s1's NN-f, s2's NN-d: trained under
    out_root, or the reference's archived state dicts under refdir
    (default ``IONFLUX_REFERENCE``) when out_root is None
    (FileNotFoundError naming the file where absent)."""
    from ionflux_torch.models.nn import NNdParams, NNfParams
    from ionflux_torch.models.registry import HH_B06

    if out_root is None:
        def net(study):
            return _reference_net(_reference_file(
                refdir, f"{study}/model-state-dict.pt"), device)

        return {
            "Original": ("hh", HH_B06, "C2--"),
            "NN-f": ("nnf", NNfParams(net=net("s1"), rgate=HH_B06), "C0--"),
            "NN-d": ("nnd", NNdParams(net=net("s2"), hh=HH_B06), "C1--"),
        }
    from ionflux_torch.studies import S1, S2, load_study_params

    models = {"Original": ("hh", HH_B06, "C2--")}
    for spec, label in [(S1, "NN-f"), (S2, "NN-d")]:
        d = os.path.join(out_root, spec.name)
        if os.path.exists(os.path.join(d, "model.npz")):
            models[label] = (spec.model_kind,
                             load_study_params(spec, d, device), "C0--")
    return models


def cached_sim(cache_dir: str, name: str, cached: bool, kind: str, params,
               proto: P.Protocol, ts, c: Constants, **kw) -> np.ndarray:
    """``eval.simulate`` on proto at ts (f32, on the protocol's device) as
    numpy f64, cached as ``<cache_dir>/<name>.npz``; with cached, an
    existing file is read instead."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}.npz")
    if cached and os.path.exists(path):
        with np.load(path) as z:
            return z["y"]
    tq = torch.as_tensor(np.asarray(ts), device=proto.v.device).to(
        torch.float32)
    y = simulate(kind, params, proto, tq, c, **kw).double().cpu().numpy()
    np.savez(path, y=y)
    return y


def _as_default(x) -> torch.Tensor:
    """Host data as a tensor of the default dtype (float32, or float64
    after ``--x64``), as ``jnp.asarray`` follows ``jax_enable_x64``."""
    return torch.tensor(np.asarray(x), dtype=torch.get_default_dtype())


def mae_row(truth: np.ndarray, preds: dict) -> dict:
    """{label: MAE of the trace against truth} (table 1 scores MAE, not
    RMSE), in the default dtype."""
    return {k: float(mae(_as_default(v), _as_default(truth)))
            for k, v in preds.items()}


def latex_table(path: str, header: list[str], rows: dict, caption: str = ""):
    """Write the reference's LaTeX tabular: a row per model, floats to three
    decimals; the text is printed too."""
    with open(path, "w") as fh:
        if caption:
            fh.write(f"% {caption}\n")
        fh.write("\\begin{tabular}{" + "l" + "c" * len(header) + "}\n")
        fh.write("\\hline\n")
        fh.write(" & " + " & ".join(header) + " \\\\\n\\hline\n")
        for name, vals in rows.items():
            cells = " & ".join(
                f"{v:.3f}" if isinstance(v, float) else str(v) for v in vals)
            fh.write(f"{name} & {cells} \\\\\n")
        fh.write("\\hline\n\\end{tabular}\n")
    with open(path) as fh:
        print(fh.read())


def sweep_panel(ax, t, traces: dict, title: str = "", xlabel: str = "t (ms)",
                ylabel: str = "I (nA)", data_label: str | None = None):
    """One comparison panel: the data in grey, the models as their
    styles."""
    for label, (y, style) in traces.items():
        if label == data_label:
            ax.plot(t, y, c="#7f7f7f", lw=0.8, label=label)
        else:
            ax.plot(t, y, style, lw=1.0, label=label)
    if title:
        ax.set_title(title, fontsize=9)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)


def zoom_inset(ax, t, traces: dict, xlim, ylim, loc=(0.55, 0.5, 0.42, 0.45)):
    """A zoom inset on ax; a trace whose style is None is drawn grey."""
    axin = ax.inset_axes(loc)
    for _label, (y, style) in traces.items():
        c = "#7f7f7f" if style is None else None
        axin.plot(t, y, style or "-", c=c, lw=0.8)
    axin.set_xlim(*xlim)
    axin.set_ylim(*ylim)
    axin.tick_params(labelsize=6)
    ax.indicate_inset_zoom(axin, edgecolor="black", alpha=0.4)
    return axin


def surface_scatter_3d(path: str, v, a, dadt, net=None, nnd_base=None):
    """The (V, a, da/dt) scatter of a derivative surface, with the learned
    surface over it when net is given (plus nnd_base's analytic a-gate for
    an NN-d net): the reference's --debug ``rates3d-*.png``."""
    plt = _pyplot()
    from mpl_toolkits import mplot3d  # noqa: F401

    fig = plt.figure(figsize=(6, 5))
    ax = plt.axes(projection="3d")
    ax.scatter(np.asarray(v), np.asarray(a), np.asarray(dadt), s=1,
               alpha=0.4)
    if net is not None:
        from ionflux_torch.models.hh import a_gate_rhs
        from ionflux_torch.models.nn import nn_surface

        dev = net.layers[0][0].device
        vv, aa = np.meshgrid(np.linspace(-130, 70, 50),
                             np.linspace(0, 1, 50))
        vt = torch.as_tensor(vv, dtype=torch.float32, device=dev)
        at = torch.as_tensor(aa, dtype=torch.float32, device=dev)
        with torch.no_grad():
            zz = nn_surface(net, vt, at)
            if nnd_base is not None:
                zz = zz + a_gate_rhs(nnd_base, at, vt)
        ax.plot_surface(vv, aa, zz.cpu().numpy(), color="C1", alpha=0.5)
    ax.set_xlabel("V (mV)")
    ax.set_ylabel("a")
    ax.set_zlabel("da/dt")
    fig.tight_layout()
    fig.savefig(path, dpi=170)
    plt.close(fig)


# ---------------------------------------------------------------------------
# The reference's composition (figures 2 and 3): voltage and current panels
# with the sweeps overlaid, zoom panels with shading and arrow scale bars.
# ---------------------------------------------------------------------------

#: seaborn's "Set2" palette, the zooms' facecolors (no seaborn import)
SET2 = [(0.4, 0.7607843137254902, 0.6470588235294118),
        (0.9882352941176471, 0.5529411764705883, 0.3843137254901961),
        (0.5529411764705883, 0.6274509803921569, 0.796078431372549),
        (0.9058823529411765, 0.5411764705882353, 0.7647058823529411),
        (0.6509803921568628, 0.8470588235294118, 0.32941176470588235),
        (1.0, 0.8509803921568627, 0.1843137254901961)]

MODEL_STYLES = {  # label -> (fmt, color)
    "Original": ("--", "C0"),
    "NN-f": ("--", "C1"),
    "NN-d": ("-.", "C2"),
    "NN-f (r1-bad ref)": ("--", "C1"),
    "NN-f (r1-bad ours)": ("-.", "C3"),
}
MODEL_LEGEND = {
    "Original": "Original",
    "NN-f": r"$a$-gate as NN (NN-f)",
    "NN-d": "NN as discrepancy term (NN-d)",
    "NN-f (r1-bad ref)": "NN-f r1-bad (reference)",
    "NN-f (r1-bad ours)": "NN-f r1-bad (retrained)",
}


def _sns_theme(plt):
    try:
        import seaborn as sns

        sns.set_theme()
    except Exception:  # no seaborn, or one that refuses this matplotlib
        plt.style.use("seaborn-v0_8-darkgrid")


def plot_sweep_panels(axv, axc, t, v, data, preds, ds=20):
    """Voltage and current panels with every sweep overlaid; v, data and
    each pred are [n_sweeps, T]."""
    for i in range(v.shape[0]):
        axv.plot(t, v[i], c="#7f7f7f", ds="steps")
        axc.plot(t[::ds], data[i][::ds], c="#7f7f7f",
                 label="__nolegend__" if i else "Data")
        for label, y in preds.items():
            fmt, color = MODEL_STYLES.get(label, ("--", "C3"))
            axc.plot(t[::ds], y[i][::ds], fmt, c=color, lw=1.0,
                     label="__nolegend__" if i else MODEL_LEGEND.get(label,
                                                                     label))
    axv.set_xlim([t[0], t[-1]])
    axc.set_xlim([t[0], t[-1]])
    axv.set_xticklabels([])


def zoom_panel(axz, axc, t, v_data, preds, window, ylim, facecolor, ds=1):
    """One zoom panel and its shading on the parent current panel: no
    ticks, arrow scale bars labelled with the window's duration and current
    range."""
    _pyplot()
    from matplotlib.patches import PathPatch
    from matplotlib.path import Path as MplPath

    t0, t1 = window
    y0, y1 = ylim
    i0, i1 = int(np.searchsorted(t, t0)), int(np.searchsorted(t, t1))
    tt = t[i0:i1:ds]
    for i in range(v_data.shape[0]):
        axz.plot(tt, v_data[i][i0:i1:ds], c="#7f7f7f")
        for label, y in preds.items():
            fmt, color = MODEL_STYLES.get(label, ("--", "C3"))
            axz.plot(tt, y[i][i0:i1:ds], fmt, c=color, lw=1.0)
    axz.set_xlim([tt[0], tt[-1]])
    axz.set_ylim([y0, y1])
    axz.set_xticks([])
    axz.set_yticks([])
    axz.set_xticklabels([])
    axz.set_yticklabels([])

    codes = [MplPath.MOVETO] + [MplPath.LINETO] * 3 + [MplPath.CLOSEPOLY]
    verts = np.array([(tt[0], y0), (tt[0], y1), (tt[-1], y1), (tt[-1], y0),
                      (0, 0)], float)
    axc.add_patch(PathPatch(MplPath(verts, codes), facecolor=facecolor,
                            edgecolor=facecolor, alpha=0.25))
    axz.add_patch(PathPatch(MplPath(verts, codes), facecolor=facecolor,
                            edgecolor=None, alpha=0.25))
    for (x, y, dx, dy) in [(1, -0.05, -1, 0), (0, -0.05, 1, 0)]:
        axz.arrow(x, y, dx, dy, length_includes_head=True, head_width=0.03,
                  head_length=0.05, clip_on=False, fc="k", ec="k",
                  transform=axz.transAxes)
    axz.text(0.5, -0.15, "%s ms" % np.around(t1 - t0, decimals=0),
             transform=axz.transAxes, ha="center", va="center")
    for (x, y, dx, dy) in [(-0.05, 1, 0, -1), (-0.05, 0, 0, 1)]:
        axz.arrow(x, y, dx, dy, length_includes_head=True, head_width=0.03,
                  head_length=0.05, clip_on=False, fc="k", ec="k",
                  transform=axz.transAxes)
    axz.text(-0.15, 0.5, "%s nA" % np.around(y1 - y0, decimals=0),
             rotation=90, transform=axz.transAxes, ha="center", va="center")


def fit_composition_cols(path, columns, ds=20, figsize=(11, 5)):
    """Figure 2's layout: a column per protocol, its voltage panel over its
    current panel, and a row of zooms below.  columns: dicts with t [T],
    v and data [n_sweeps, T], preds {label: [n_sweeps, T]} and zooms [(t0,
    t1, y0, y1, facecolor)]."""
    plt = _pyplot()
    _sns_theme(plt)
    n = len(columns)
    fig = plt.figure(figsize=figsize)
    grid = plt.GridSpec(4 + 1 + 12 + 5 + 9, 2 * n, hspace=0.0, wspace=0.0)
    for i, col in enumerate(columns):
        c0, c1 = 2 * i, 2 * (i + 1)
        axv = fig.add_subplot(grid[:4, c0:c1])
        axc = fig.add_subplot(grid[5:17, c0:c1])
        plot_sweep_panels(axv, axc, col["t"], col["v"], col["data"],
                          col["preds"], ds)
        axc.set_xlabel("Time (ms)", fontsize=12)
        if i == 0:
            axv.set_ylabel("Voltage\n(mV)", fontsize=12)
            axc.set_ylabel("Current\n(nA)", fontsize=12)
            axc.legend(loc="lower left", bbox_to_anchor=(-0.02, 1.55),
                       ncol=4, columnspacing=1.2, handletextpad=0.4,
                       bbox_transform=axc.transAxes)
        for iz, (t0, t1, y0, y1, fc) in enumerate(col["zooms"]):
            axz = fig.add_subplot(grid[-9:, c0 + iz])
            if i == 0 and iz == 0:
                axz.set_ylabel("Zoom in", fontsize=12)
            zoom_panel(axz, axc, col["t"], col["data"], col["preds"],
                       (t0, t1), (y0, y1), fc)
    fig.savefig(path, pad_inches=0.3, dpi=200, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def fit_composition_permodel_zoom(path, t, v, data, preds, zoom, zoom_ylim,
                                  facecolor, ylim=None, ds=20,
                                  figsize=(11, 5)):
    """Figure 4-s's layout: one protocol's voltage panel over its current
    panel over a row of zoom panels, one a model, all on the same window,
    each overlaying the data with that model's prediction; arrow scale
    bars on the first zoom only.  v, data and each pred are [n_sweeps, T];
    zoom = (t0, t1), zoom_ylim = (y0, y1)."""
    plt = _pyplot()
    from matplotlib.patches import PathPatch
    from matplotlib.path import Path as MplPath

    _sns_theme(plt)
    plt.rcParams["axes.facecolor"] = "#E4EDE4"
    fig = plt.figure(figsize=figsize)
    grid = plt.GridSpec(4 + 1 + 7 + 5 + 14, 3, hspace=0.0, wspace=0.0)
    axv = fig.add_subplot(grid[:4, :3])
    axc = fig.add_subplot(grid[5:12, :3])
    plot_sweep_panels(axv, axc, t, v, data, preds, ds)
    axv.set_ylabel("Voltage\n(mV)", fontsize=12)
    axc.set_ylabel("Current\n(nA)", fontsize=12)
    axc.set_xlabel("Time (ms)", fontsize=12)
    if ylim is not None:
        axc.set_ylim(list(ylim))

    t0, t1 = zoom
    y0, y1 = zoom_ylim
    i0, i1 = int(np.searchsorted(t, t0)), int(np.searchsorted(t, t1))
    tt = t[i0:i1:ds]
    codes = [MplPath.MOVETO] + [MplPath.LINETO] * 3 + [MplPath.CLOSEPOLY]
    verts = np.array([(tt[0], y0), (tt[0], y1), (tt[-1], y1), (tt[-1], y0),
                      (0, 0)], float)
    axc.add_patch(PathPatch(MplPath(verts, codes), facecolor=facecolor,
                            edgecolor=facecolor, alpha=0.25))
    for im, (label, y) in enumerate(preds.items()):
        axz = fig.add_subplot(grid[-14:, im:im + 1])
        fmt, color = MODEL_STYLES.get(label, ("--", "C3"))
        for i in range(data.shape[0]):
            axz.plot(tt, data[i][i0:i1:ds], c="#7f7f7f")
            axz.plot(tt, y[i][i0:i1:ds], fmt, c=color, lw=1.0)
        axz.set_xlim([tt[0], tt[-1]])
        axz.set_ylim([y0, y1])
        axz.set_xticks([])
        axz.set_yticks([])
        axz.set_xticklabels([])
        axz.set_yticklabels([])
        axz.add_patch(PathPatch(MplPath(verts, codes), facecolor=facecolor,
                                edgecolor=None, alpha=0.25))
        if im == 0:
            axz.set_ylabel("Zoom in", fontsize=12)
            for (x, yy, dx, dy) in [(1, -0.05, -1, 0), (0, -0.05, 1, 0)]:
                axz.arrow(x, yy, dx, dy, length_includes_head=True,
                          head_width=0.03, head_length=0.05, clip_on=False,
                          fc="k", ec="k", transform=axz.transAxes)
            axz.text(0.5, -0.15, "%s ms" % np.around(t1 - t0, decimals=0),
                     transform=axz.transAxes, ha="center", va="center")
            for (x, yy, dx, dy) in [(-0.05, 1, 0, -1), (-0.05, 0, 0, 1)]:
                axz.arrow(x, yy, dx, dy, length_includes_head=True,
                          head_width=0.03, head_length=0.05, clip_on=False,
                          fc="k", ec="k", transform=axz.transAxes)
            axz.text(-0.15, 0.5, "%s nA" % np.around(y1 - y0, decimals=1),
                     rotation=90, transform=axz.transAxes, ha="center",
                     va="center")
    axc.legend(loc="lower left", bbox_to_anchor=(0.0, 1.7), ncol=4,
               columnspacing=4, bbox_transform=axc.transAxes)
    fig.align_ylabels([axv, axc])
    fig.savefig(path, pad_inches=0.02, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def fit_composition_rows(path, top_columns, rows, ds=20, figsize=(11, 13.5)):
    """Figure 3's layout: a top row of sweep columns (no zooms), then
    full-width single-trace rows, each with its own row of zooms."""
    plt = _pyplot()
    _sns_theme(plt)
    a1, a2, az = 4, 12, 9
    block = a1 + 1 + a2 + 2           # V + gap + I
    zblock = az + 4                   # zoom row + gap
    n_top = len(top_columns)
    total_rows = block + (block + zblock) * len(rows) + 4
    ncols = 12  # a fine column grid, so 1-3 zooms a row divide evenly
    fig = plt.figure(figsize=figsize)
    grid = plt.GridSpec(total_rows, ncols, hspace=0.0, wspace=0.0)

    r = 0
    for i, col in enumerate(top_columns):
        w = ncols // n_top
        c0, c1 = w * i, w * (i + 1) - (1 if n_top > 1 and i < n_top - 1
                                       else 0)
        axv = fig.add_subplot(grid[r:r + a1, c0:c1])
        axc = fig.add_subplot(grid[r + a1 + 1:r + a1 + 1 + a2, c0:c1])
        plot_sweep_panels(axv, axc, col["t"], col["v"], col["data"],
                          col["preds"], ds)
        if i == 0:
            axv.set_ylabel("Voltage\n(mV)", fontsize=12)
            axc.set_ylabel("Current\n(nA)", fontsize=12)
            axc.legend(loc="lower left", bbox_to_anchor=(-0.02, 1.55),
                       ncol=4, columnspacing=1.2, handletextpad=0.4,
                       bbox_transform=axc.transAxes)
        axc.set_xlabel("Time (ms)", fontsize=12)
    r += block + 2
    for row in rows:
        axv = fig.add_subplot(grid[r:r + a1, :])
        axc = fig.add_subplot(grid[r + a1 + 1:r + a1 + 1 + a2, :])
        plot_sweep_panels(axv, axc, row["t"], row["v"], row["data"],
                          row["preds"], ds)
        axv.set_ylabel("Voltage\n(mV)", fontsize=12)
        axc.set_ylabel("Current\n(nA)", fontsize=12)
        axc.set_xlabel("Time (ms)", fontsize=12)
        r += block + 2
        n_z = len(row["zooms"])
        for iz, (t0, t1, y0, y1, fc) in enumerate(row["zooms"]):
            w = ncols // max(n_z, 1)
            axz = fig.add_subplot(grid[r:r + az, w * iz:w * (iz + 1) - 1])
            if iz == 0:
                axz.set_ylabel("Zoom in", fontsize=12)
            zoom_panel(axz, axc, row["t"], row["data"], row["preds"],
                       (t0, t1), (y0, y1), fc, ds=1)
        r += zblock - 2
    fig.savefig(path, pad_inches=0.3, dpi=200, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def portrait_trajectories(kind: str, name: str, y0, cache_dir: str,
                          cached: bool = False, device=None):
    """(a, da/dt) along a recorded protocol: "hh", the d0-fitted candidate
    (da/dt from its a-gate), or "gta", the Markov ground truth's a-gate
    (which carries da/dt as its second state); cached as
    ``<cache_dir>/<name>-<kind>.npz``."""
    from ionflux_torch import protorec
    from ionflux_torch.eval import solve_states_real
    from ionflux_torch.models.hh import a_gate_rhs
    from ionflux_torch.models.registry import HH_D0_FIT, MARKOV_B06

    cache = os.path.join(cache_dir, f"{name}-{kind}.npz")
    if cached and os.path.exists(cache):
        with np.load(cache) as d:
            return d["a"], d["z"]
    dev = resolve_device(device)
    ys = solve_states_real(
        kind, HH_D0_FIT if kind == "hh" else MARKOV_B06, name,
        y0=torch.as_tensor(y0, dtype=torch.float32, device=dev))
    a = ys[:, 0]
    if kind == "hh":
        v = torch.as_tensor(protorec.load_voltage(name)[0], device=dev)
        z = a_gate_rhs(HH_D0_FIT, ys[:, 0], v.to(torch.float32))
    else:
        z = ys[:, 1]
    a, z = a.cpu().numpy(), z.cpu().numpy()
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(cache, a=a, z=z)
    return a, z


def phase_portrait_figure(path, cases, cache_dir, cached=False, ds=10,
                          view=(30, -125), v_hi=60.0, device=None):
    """Figure 1's two 3-D (V, a, da/dt) panels: (A) the d0-fitted
    candidate's trajectories on its own surface, (B) the ground truth's
    leaving it.  cases: [(protocol name, color, label)]."""
    plt = _pyplot()
    from ionflux_torch import protorec
    from ionflux_torch.models.hh import a_gate_rhs
    from ionflux_torch.models.registry import HH_D0_FIT

    def plot_segments(ax, v, a, z, color, label):
        bounds = np.flatnonzero(np.diff(v) != 0) + 1
        # continuous waveforms (the sinewave, the APs) change at every
        # sample: segment only at real steps (plateaus >= 5 ms)
        if len(bounds) > 200:
            keep = np.diff(np.concatenate([[0], bounds])) > 50
            bounds = bounds[keep]
        bounds = np.concatenate([bounds, [len(v)]])
        i = 0
        for f in bounds:
            sl = slice(i, f, ds)
            ax.plot(v[sl], a[sl], z[sl], alpha=0.8, color=color,
                    label="__nolegend__" if i else label)
            ax.scatter(v[i], a[i], z[i], alpha=0.8, color=color, marker=".")
            ax.scatter(v[f - 1], a[f - 1], z[f - 1], alpha=0.8, color=color,
                       marker=".")
            i = f

    fig = plt.figure(figsize=(8.5, 3.75))
    axes = [fig.add_subplot(1, 2, k + 1, projection="3d") for k in range(2)]
    vv, aa = np.meshgrid(np.linspace(-120.0, v_hi, 50),
                         np.linspace(0.0, 1.0, 50), indexing="ij")
    surf = a_gate_rhs(HH_D0_FIT, torch.as_tensor(aa),
                      torch.as_tensor(vv)).numpy()
    for ax, kind, y0 in [(axes[0], "hh", [0.0, 1.0]),
                         (axes[1], "gta", [0.0, 0.0])]:
        for name, color, label in cases:
            v, _ = protorec.load_voltage(name)
            a, z = portrait_trajectories(kind, name, y0, cache_dir, cached,
                                         device)
            plot_segments(ax, v, a, z, color, label)
        ax.plot_surface(vv, aa, surf, color="C0", alpha=0.5)
        ax.view_init(*view)
        ax.set_xlabel(r"$V$ (mV)")
        ax.set_ylabel(r"$a$")
        ax.zaxis.set_rotate_label(False)
        ax.set_zlabel(r"$\frac{da}{dt}$", rotation=0, fontsize=13)
    axes[1].legend(ncol=2)
    for k, ax in enumerate(axes):
        ax.text2D(-0.05, 0.925, f"({chr(65 + k)})", size=12, weight="bold",
                  va="bottom", ha="right", transform=ax.transAxes)
    fig.savefig(path, pad_inches=0.02, dpi=200, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {path}")


def load_r_models(out_root: str, oracle: bool = False,
                  refdir: str | None = None, device=None) -> list:
    """The r-study trio [(label, kind, params, constants)]: the cell-5 HH
    fit ("Original", CELL5_RAW), r1's NN-f (CELL5_R1) and r2's NN-d
    (CELL5_R2), each (g, E) as the reference's table 2 sets them.  The
    nets are the trained best checkpoints under out_root (best-model.npz,
    else model.npz), or with ``oracle`` the reference's archived ones under
    refdir (default ``IONFLUX_REFERENCE``): r1/best-model-checkpoint-2.pt
    (its "state_dict") and r2/model-state-dict-2.pt (FileNotFoundError
    naming the file where absent)."""
    from ionflux_torch.models.nn import NNdParams, NNfParams
    from ionflux_torch.models.registry import (CELL5_R1, CELL5_R2,
                                               CELL5_RAW, HH_CELL5_FIT,
                                               HH_CELL5_INIT)
    from ionflux_torch.rstudies import R1, R2
    from ionflux_torch.utils.ckpt import load_pytree

    if oracle:
        r1 = NNfParams(net=_reference_net(_reference_file(
            refdir, "r1/best-model-checkpoint-2.pt"), device, "state_dict"),
            rgate=HH_CELL5_INIT)
        r2 = NNdParams(net=_reference_net(_reference_file(
            refdir, "r2/model-state-dict-2.pt"), device), hh=HH_CELL5_FIT)
    else:
        out = []
        for spec in (R1, R2):
            path = os.path.join(out_root, spec.name, "best-model.npz")
            if not os.path.exists(path):
                path = os.path.join(out_root, spec.name, "model.npz")
            out.append(load_pytree(path, spec.model_kind, device))
        r1, r2 = out
    return [("Original", "hh", HH_CELL5_FIT, CELL5_RAW),
            ("NN-f", "nnf", r1, CELL5_R1),
            ("NN-d", "nnd", r2, CELL5_R2)]


def dense_measurement(idx, vals, n, max_gap: int = 30):
    """A recovered measurement on the retained-sample lattice (every 7th
    sample inside the capacitance-masked runs) as a dense trace of n
    samples for plotting: interpolated inside runs, NaN across the mask's
    gaps (more than max_gap samples) and outside the lattice, so
    matplotlib breaks the line there."""
    idx = np.asarray(idx, np.int64)
    d = np.interp(np.arange(n), idx, np.asarray(vals, np.float64))
    for a, b in zip(idx[:-1], idx[1:]):
        if b - a > max_gap:
            d[a + 1:b] = np.nan
    d[:idx[0]] = np.nan
    d[idx[-1] + 1:] = np.nan
    return d
