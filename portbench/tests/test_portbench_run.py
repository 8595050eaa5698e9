"""One run of a cell on the CPU at a tiny size: the result line's keys,
the refusals (no card, the JAX package loaded), and a cell, mix and
metric added by files and entries alone."""
import json
import shutil
import sys
import types

import pytest

from portbench import manifest as M, run
from portbench.tests._tiny import TINY_CONFIG, TINY_MIX, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["qwen3-4b.step-n64",
                                  "mixtral-8x7b.step-n64",
                                  "qwen3-4b.fewshot-open"])
def test_untraced_run_reports_its_end_to_end_metrics(cell):
    res = run_tiny(cell)
    assert list(res)[:5] == KEYS and list(res)[5] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    want = {m["name"] for m in M.Manifest().metrics(cell, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(v["limit"] >= 0 for v in res["compared"].values())


@pytest.mark.parametrize("cell", ["qwen3-4b.step-n64",
                                  "qwen3-4b.fewshot-open"])
def test_traced_run_profiles_inside_the_window(cell):
    res = run_tiny(cell, seconds=5.0, trace=True)
    keys = list(res)
    assert keys[:6] == KEYS + ["breakdown"] and keys[6] == "compared"
    assert {"busy_s", "window_s"} <= set(res["device"])
    stretch = res["notes"]["profiled_from_s"]
    assert 0 < stretch < res["notes"]["window_s"]
    # the readers of CUDA events and kernel names read nothing on the CPU
    silent = {"mfu", "device_idle_share", "products_ms_per_iter",
              "k1a_roofline", "k2_roofline"}
    want = {m["name"] for m in M.Manifest().metrics(cell, "per_layer")
            if m["name"].split(".")[0] not in silent}
    assert set(res["metrics"]) == want
    json.dumps(res)


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", "qwen3-4b.step-n64", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    before = run.forbidden_modules()
    for name in ("repro_torch.serving", "reproduce", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.serving",
                        types.ModuleType("repro.serving"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    found = run.forbidden_modules()
    assert "repro" in found and "jax" in found
    assert "repro_torch" not in found


def test_a_cell_mix_and_metric_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and
    a cell by new files and BENCHMARK.json entries; the unchanged harness
    runs the new cell and reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(M.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((M.ROOT / "BENCHMARK.json").read_text())
    bench = root / "portbench"
    cfg = json.loads((bench / "configs" / "qwen3-4b-thinking.json")
                     .read_text())
    cfg.update(TINY_CONFIG, name="dummy-model")
    (bench / "configs" / "dummy-model.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "step-n64.json").read_text())
    mix.update(TINY_MIX, traces=2)
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy_count.py").write_text(
        "def read(rec):\n    return float(len(rec['problems']))\n")
    (bench / "limits" / "dummy.cell.json").write_text(
        (bench / "limits" / "qwen3-4b.step-n64.json").read_text())
    spec["configs"].append({"name": "dummy-model", "source": "a test",
                            "file": "portbench/configs/dummy-model.json",
                            "reduced": cfg["reduced"], "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy-model",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_count", "unit": "problems",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    man = M.Manifest(root, bench)
    res = run.run_cell("dummy.cell", 7, 1.0, False, device="cpu",
                       manifest=man)
    assert res["correct"] is True
    assert res["metrics"]["dummy_count"]["value"] == res["attempted"] >= 1
    assert {"tokens_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.cuda
def test_tiny_cell_on_the_card(cuda_card):
    res = run.run_cell("qwen3-4b.step-n64", 11, 1.0, True, device="cuda",
                       config_override=TINY_CONFIG, mix_override=TINY_MIX)
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
