"""The harness finds every cell, configuration, traffic mix, driver and
per-layer reader by name, and BENCHMARK.json names only what exists."""

import json
import os
import sys

import pytest

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


def test_configs_hold_published_widths():
    for c in BENCHMARK["configs"]:
        cfg = H.load_json("configs", c["name"])
        assert cfg["sizes"] == [2] + [200] * 6 + [1]
        assert c["reduced"] == cfg["reduced"] == []
        assert c["file"] == f"benchmark/configs/{c['name']}.json"


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
    from benchmark import gen
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
    for name in ("mfu.validate", "mfu.train", "mfu.node"):
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
