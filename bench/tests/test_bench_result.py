"""The result line and the lookups that make the harness data-driven."""

import json
import sys
import types

import pytest

from bench import core


def test_result_line_keys_in_order_with_checks_last():
    line = core.result_line(correct=True, attempted=3, failed=0,
                            metrics={"m": {"value": 1.0, "unit": "s"}},
                            device={"platform": "gpu"},
                            checks={"x": {"value": 0.0, "limit": 1.0}},
                            breakdown={"device_ops": [], "idle_gaps": []})
    assert list(json.loads(line)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "breakdown",
                                      "checks"]
    line = core.result_line(correct=False, attempted=0, failed=0, metrics={},
                            device={}, checks={})
    assert list(json.loads(line)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "checks"]


def test_a_cell_added_to_a_folder_is_found_by_name(tiny_root):
    cell = core.Cell("olmoe-train-d8", tiny_root)
    assert cell.config["name"] == "tiny"
    assert cell.traffic["kind"] == "train" and cell.traffic["batch"] == 4
    assert cell.driver().__name__ == "bench.kinds.train"
    assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap",
                                "route_gap"}
    with pytest.raises(KeyError):
        core.Cell("no-such-cell", tiny_root)


def test_the_configuration_names_its_reference_and_port_arch(monkeypatch):
    """A configuration of another model family brings its own
    ``bench/reference/<name>.py`` and ``bench/archs/<name>.py``: the
    harness takes the model, the weight layout and the port's
    architecture from the modules the file's ``reference`` names."""
    ref = types.ModuleType("bench.reference.other_lm")
    ref.shapes = lambda cfg: {("w",): ((2, 3), 1.0, cfg["dtype"])}
    arch = types.ModuleType("bench.archs.other_lm")
    arch.port_arch = lambda cfg: ("arch of", cfg["name"])
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setitem(sys.modules, arch.__name__, arch)
    cfg = {"name": "x", "reference": "other_lm", "dtype": "float32"}
    assert core.reference(cfg) is ref
    assert core.port_arch(cfg) == ("arch of", "x")
    torch = pytest.importorskip("torch")
    from bench import weights
    tree = weights.make(cfg, 3, torch.device("cpu"))
    assert tree["w"].shape == (2, 3)
    assert core.reference({"reference": "moe_lm"}).__name__ == \
        "bench.reference.moe_lm"
    with pytest.raises(ModuleNotFoundError):
        core.reference({"reference": "no_such_model"})


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(core.reader(m["name"]))
    for c in spec["configs"]:
        cfg = core.load_json(core.ROOT / c["file"])
        assert callable(core.reference(cfg).shapes)
        assert (core.BENCH / "archs" / f"{cfg['reference']}.py").exists()
    for w in spec["workloads"]:
        cell = core.Cell(w["name"])
        assert cell.driver().run
        assert cell.metrics(False) and cell.metrics(True)
        names = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.metrics(True):
            assert m["moves"] in names
