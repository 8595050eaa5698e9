"""The ported examples (``examples/torch_*.py``) on the CPU, their steps
cut: each runs its ``main`` and prints the summary lines of its JAX
counterpart (``examples/quickstart.py``, ``train_multiarch.py``,
``serve_parallel_scaling.py``), and imports only ``repro_torch``.
"""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.scorer import init_scorer  # noqa: E402
from repro_torch.launch import artifacts  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.training.checkpoint import save_pytree  # noqa: E402
from test_torch_imports import _forbidden_imports  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
PORTED = ("torch_quickstart", "torch_train_multiarch",
          "torch_serve_parallel_scaling")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_only_the_port(name):
    path = EXAMPLES / f"{name}.py"
    assert _forbidden_imports(path) == []
    imported = set(re.findall(r"^(?:from|import) (\w+)", path.read_text(),
                              re.M))
    assert "repro_torch" in imported
    assert imported <= {"repro_torch", "argparse", "random", "time", "torch"}


QUICKSTART_LINE = re.compile(
    r"^   (sc|step) *: answer=\S+ \(gold=\d+, (?:OK|WRONG)\)  "
    r"latency=\d+\.\d\ds  wait=\d+\.\d\ds  pruned=(\d+)  "
    r"preemptions=(\d+)$", re.M)


@pytest.mark.parametrize("extra", [[], ["--chunk", "8"]])
def test_quickstart(extra, capsys):
    """The three steps at 10 LM steps; the tight pool of step 3 makes SC
    preempt and STEP prune without preempting, as in the JAX example,
    with prompts prefilled whole or (``--chunk 8``, as ``chip_smoke.py``
    runs it on the card) in chunks."""
    res = _load("torch_quickstart").main(["--device", "cpu", "--steps", "10",
                                          *extra])
    out = capsys.readouterr().out
    for head in ("== 1. train the reasoning LM (tiny, synthetic task) ==",
                 "== 2. sample -> verify -> train the step scorer ==",
                 "== 3. SC vs STEP under a tight KV pool =="):
        assert head in out
    assert re.search(r"^   scorer trained on \d+ boundary states "
                     r"\(sampled correct-rate \d\.\d\d\)$", out, re.M)
    lines = {m.group(1): m for m in QUICKSTART_LINE.finditer(out)}
    assert sorted(lines) == ["sc", "step"]
    assert int(lines["sc"].group(3)) > 0          # SC preempts
    assert int(lines["step"].group(2)) > 0        # STEP prunes ...
    assert int(lines["step"].group(3)) == 0       # ... and never preempts
    assert res["step"].wait_s == 0.0 and res["sc"].wait_s > 0.0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b",
                                  "mixtral-8x7b"])
def test_train_multiarch(arch, capsys):
    first, last = _load("torch_train_multiarch").main(
        ["--arch", arch, "--steps", "4", "--batch", "4", "--seq", "32",
         "--device", "cpu"])
    out = capsys.readouterr().out
    cfg = serving_config(arch)
    assert re.search(rf"^arch={re.escape(cfg.name)} \({cfg.arch_type}\) "
                     r"params=[\d,]+$", out, re.M)
    assert len(re.findall(r"^  step +\d+ loss \d+\.\d{4} \(\d+\.\ds\)$", out,
                          re.M)) == 2
    assert re.search(rf"^loss {first:.3f} -> {last:.3f} over 4 steps$", out,
                     re.M)
    assert last < first


def test_serve_parallel_scaling(tmp_path, monkeypatch, capsys):
    """The five methods on artifacts saved in the JAX package's layout
    (a seeded init of the serving config and a scorer), loaded through
    ``launch.artifacts.load_artifacts``, two problems of four traces."""
    cfg = serving_config()
    g = torch.Generator().manual_seed(0)
    save_pytree(str(tmp_path / "model.npz"), init_params(cfg, g))
    save_pytree(str(tmp_path / "scorer.npz"), init_scorer(g, cfg.d_model))
    monkeypatch.setattr(artifacts, "ART_DIR", str(tmp_path))
    res = _load("torch_serve_parallel_scaling").main(
        ["--problems", "2", "--traces", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^method +acc +tokens +lat\(s\) +wait\(s\) +pruned "
                     r"+preempt$", out, re.M)
    rows = re.findall(r"^(cot|sc|slimsc|deepconf|step) +\d\.\d\d +\d+ "
                      r"+\d+\.\d\d +\d+\.\d\d +\d+ +\d+$", out, re.M)
    assert rows == ["cot", "sc", "slimsc", "deepconf", "step"]
    assert list(res) == rows
    assert all(len(r.per_problem) == 2 for r in res.values())


def test_examples_default_to_the_card():
    """With no ``--device`` an example runs on CUDA, and raises without a
    card (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_train_multiarch").main(["--steps", "1"])
