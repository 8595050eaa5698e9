"""BENCHMARK.json and the files it names: every configuration, mix,
metric and limits file loads by name, and the manifest keeps its shape:
its keys, names, units, lengths and bounds."""
import json
import re

import pytest

from portbench import manifest as M

MAN = M.Manifest()
SPEC = MAN.spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_loads_and_states_its_cuts(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("portbench/configs/")
    body = MAN.config(cfg["name"])
    assert body["name"] == cfg["name"]
    assert sorted(body["reduced"]) == sorted(cfg["reduced"])
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in body
        assert not key.endswith(("_dim", "_rank")) and key != "d_model"
    assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    mix = MAN.traffic(cell["traffic"])
    assert mix["loop"] in ("closed", "open")
    limits = json.loads((MAN.dir / "limits" / f"{cell['name']}.json")
                        .read_text())
    assert {"prune_misses", "vote_misses"} <= set(limits)
    e2e = MAN.metrics(cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert MAN.metrics(cell["name"], "per_layer")


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = MAN.reader(metric["name"])
    assert callable(reader.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in SPEC["per_layer"]:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        for cell in metric["workloads"]:
            assert metric["moves"] in {
                m["name"] for m in MAN.metrics_e2e(cell)}
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_layers_are_named_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    assert layers["kernels"] == ["k1a_roofline", "k2_roofline",
                                 "k1a_roofline.open", "k2_roofline.open"]
