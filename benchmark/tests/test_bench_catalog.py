"""The harness finds every cell, configuration, traffic mix, driver and
per-layer reader by name, and BENCHMARK.json names only what exists."""

import json
import os
import sys

import numpy as np
import pytest

from benchmark import flops, gen
from benchmark import harness as H

BENCHMARK = json.load(open(os.path.join(H.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = H.Cell.find(name, seed=2**31 + 5)
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == name)
    assert cell.workload["config"] == entry["config"]
    assert cell.workload["traffic"] == entry["traffic"]
    assert cell.config["name"] == entry["config"]
    driver = cell.driver()
    assert callable(driver.setup) and callable(driver.control)
    metric = cell.workload["metric"]
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert name in e2e[metric].get("workloads", [name])
    assert cell.workload["unit"] == e2e[metric]["unit"]
    assert cell.workload["limits"]


def test_every_per_layer_metric_has_a_reader():
    readers = H.readers()
    for m in BENCHMARK["per_layer"]:
        reader = readers[m["name"]]
        assert reader.UNIT == m["unit"]
        for w in m["workloads"]:
            cell = H.Cell.find(w, seed=1)
            assert cell.mix["driver"] in reader.DRIVERS
            assert cell.workload["metric"] == m["moves"]


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        H.Cell.find("no.such.cell", seed=1)
    with pytest.raises(FileNotFoundError):
        H.load_module("metrics", "no_such_metric")


# (n_layers, n_nodes) of the MLP each published reference file builds:
# Lei & Mirams 2021's train-d1.py / train-d2.py, and Table S1's
# architectures/s00.py-s11.py (chonlei/neural-ode-ion-channels)
PUBLISHED = {
    "train-d1.py": (5, 200), "train-d2.py": (5, 200),
    "architectures/s00.py": (5, 200), "architectures/s01.py": (1, 200),
    "architectures/s02.py": (10, 200), "architectures/s03.py": (5, 10),
    "architectures/s04.py": (1, 10), "architectures/s05.py": (10, 10),
    "architectures/s06.py": (5, 500), "architectures/s07.py": (1, 500),
    "architectures/s08.py": (10, 500), "architectures/s09.py": (5, 100),
    "architectures/s10.py": (1, 100), "architectures/s11.py": (10, 100),
}
GATE_SCALARS = 8


def leaf_shapes(sizes) -> list[tuple]:
    """A checkpoint's leaves in order (gen.npz_leaves): (W [in, out],
    b [out]) of each layer, then the gate scalars."""
    return [s for a, b in zip(sizes[:-1], sizes[1:])
            for s in ((a, b), (b,))] + [()] * GATE_SCALARS


def width_faults(cfg: dict, leaves) -> list[str]:
    """How a configuration and its checkpoint's leaves depart from the
    widths its source publishes (empty where they do not): the source names
    one reference file, whose (n_layers, n_nodes) the configuration holds;
    ``sizes`` is 2, n_nodes x (n_layers + 1), 1; ``parameters`` is their
    count; the leaves are (W [in, out], b [out]) of those sizes, then the 8
    gate scalars; nothing is reduced."""
    files = [f for f in PUBLISHED if f in cfg["source"]]
    if len(files) != 1:
        return [f"source names {files}, not one published file"]
    n_layers, n_nodes = PUBLISHED[files[0]]
    faults = []
    if (cfg["n_layers"], cfg["n_nodes"]) != (n_layers, n_nodes):
        faults.append(f"{files[0]} publishes {n_layers} x {n_nodes}")
    sizes = [2] + [n_nodes] * (n_layers + 1) + [1]
    if cfg["sizes"] != sizes:
        faults.append(f"sizes {cfg['sizes']} are not {sizes}")
    if cfg["parameters"] != flops.mlp_work(sizes)[1]:
        faults.append(f"parameters {cfg['parameters']} are not "
                      f"{flops.mlp_work(sizes)[1]}")
    shapes = leaf_shapes(sizes)
    got = [np.shape(x) for x in leaves]
    if got != shapes:
        faults.append(f"checkpoint leaves {got} are not {shapes}")
    if cfg["reduced"] != []:
        faults.append(f"reduced {cfg['reduced']}")
    return faults


def _config(source, n_layers, n_nodes, sizes=None, parameters=None):
    sizes = sizes or [2] + [n_nodes] * (n_layers + 1) + [1]
    return dict(source=source, n_layers=n_layers, n_nodes=n_nodes,
                sizes=sizes, reduced=[],
                parameters=(parameters if parameters is not None
                            else flops.mlp_work(sizes)[1]))


def _leaves(sizes):
    return [np.zeros(s, np.float32) for s in leaf_shapes(sizes)]


@pytest.mark.parametrize("name", [c["name"] for c in BENCHMARK["configs"]])
def test_configs_hold_published_widths(name):
    (c,) = [c for c in BENCHMARK["configs"] if c["name"] == name]
    cfg = H.load_json("configs", name)
    assert cfg["source"] == c["source"]
    assert width_faults(cfg, gen.npz_leaves(cfg["checkpoint"])) == []
    assert c["reduced"] == cfg["reduced"] == []
    assert c["file"] == f"benchmark/configs/{name}.json"


@pytest.mark.parametrize("arch,parameters", [("s08", 2_507_001),
                                             ("s03", 591)])
def test_width_check_admits_other_published_widths(arch, parameters):
    """Table S1's widest net and a narrow one, each with its committed
    r1-tune checkpoint."""
    n_layers, n_nodes = PUBLISHED[f"architectures/{arch}.py"]
    cfg = _config(f"Lei & Mirams 2021, Table S1; architectures/{arch}.py",
                  n_layers, n_nodes)
    assert cfg["parameters"] == parameters
    leaves = gen.npz_leaves(f"out/r1-tune/{arch}/best-model.npz")
    assert width_faults(cfg, leaves) == []


D1 = "Lei & Mirams 2021; model M1 (NN-f), train-d1.py"


@pytest.mark.parametrize("cfg,leaves", [
    # no source publishes 5 x 256
    (_config(D1, 5, 256), _leaves([2] + [256] * 6 + [1])),
    # sizes that disagree with n_layers / n_nodes
    (_config(D1, 5, 200, sizes=[2] + [200] * 5 + [1], parameters=201_801),
     _leaves([2] + [200] * 6 + [1])),
    # a parameter count off by one
    (_config(D1, 5, 200, parameters=201_802),
     _leaves([2] + [200] * 6 + [1])),
    # a checkpoint whose first W is stored [out, in]
    (_config(D1, 5, 200),
     [np.zeros((200, 2))] + _leaves([2] + [200] * 6 + [1])[1:]),
    # a source that names no published file
    (_config("Lei & Mirams 2021", 5, 200), _leaves([2] + [200] * 6 + [1])),
], ids=["5x256", "sizes", "parameters", "leaves", "source"])
def test_width_check_refuses_unpublished_widths(cfg, leaves):
    assert width_faults(cfg, leaves)


@pytest.mark.parametrize("name", ["ionflux", "ionflux.eval", "jax",
                                  "jax.numpy", "jaxlib", "flax.linen"])
def test_forbidden_module_check_catches(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, object())
    assert name in H.forbidden_modules()


@pytest.mark.parametrize("name", ["ionflux_torch", "ionflux_torch.eval",
                                  "jaxtyping", "flaxen"])
def test_forbidden_module_check_spares(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, object())
    assert name not in H.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(H.BENCH, "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            text = open(os.path.join(ref, fn)).read()
            assert "ionflux" not in text, fn
            assert "import jax" not in text, fn


def test_recordings_equal_the_programs():
    from ionflux_torch import protorec

    mix = H.load_json("traffic", "table1-64")
    for r in mix["recordings"]:
        v, dt = gen.recording(r)
        want, want_dt = protorec.load_voltage(r["name"])
        assert dt == want_dt and v.shape == want.shape
        assert (v == want).all(), r["name"]


@pytest.mark.parametrize("busy_us,window_s,want", [
    (9.0e5, 1.0, 10.0), (1.0e6, 1.0, 0.0), (0.0, 1.0, None),
    (5.0e5, 0.0, None)])
def test_idle_share_reads_one_traced_run(busy_us, window_s, want):
    tr = dict(busy_us=busy_us, window_s=window_s, plain_s=123.0)
    got = H.idle_share(tr)
    assert got == pytest.approx(want) if want is not None else got is None
    for name in ("idle.validate", "idle.train", "idle.node"):
        assert H.readers()[name].read(tr) == got


@pytest.mark.parametrize("ops,calls,plain_s,want", [
    (67e12, 2, 4.0, 50.0), (0.0, 2, 4.0, None), (1e12, 0, 4.0, None),
    (1e12, 1, 0.0, None)])
def test_peak_share_counts_every_call(ops, calls, plain_s, want):
    tr = dict(info={"call_ops": ops}, calls=calls, plain_s=plain_s,
              peak=67e12)
    got = H.peak_share(tr)
    assert got == pytest.approx(want) if want is not None else got is None
    for name in ("mfu.train", "mfu.node"):
        assert H.readers()[name].read(tr) == got


def test_surface_noise_is_finite_where_rand_draws_zero(monkeypatch):
    import torch

    from benchmark.drivers import surface_train as S

    cell = H.Cell.find("nnd.train", seed=2**31 + 5,
                       mix=dict(H.load_json("traffic", "d2-surface"),
                                points=64))
    cell.device = torch.device("cpu")
    monkeypatch.setattr(torch, "rand",
                        lambda shape, **kw: torch.zeros(shape))
    x, y, residual = S.surface(cell)
    assert torch.isfinite(x).all() and torch.isfinite(y).all()
    assert torch.isfinite(residual).all()
