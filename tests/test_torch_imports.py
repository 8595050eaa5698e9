"""The PyTorch port stands alone: no module of ``src/repro_torch`` imports
jax, the JAX package ``repro`` (not even its jax-free modules) or the
JAX package's ``benchmarks``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro", "benchmarks")


def _modules():
    return sorted(PORT.rglob("*.py"))


def _forbidden_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            # "repro_torch..." is the port itself: compare the top package
            if name.split(".")[0] in FORBIDDEN:
                bad.append((node.lineno, name))
    return bad


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in _modules()}
    for want in ("serving/engine.py", "serving/scheduler.py",
                 "models/model.py", "kernels/paged_attention.py",
                 "kernels/step_score.py", "models/bridge.py",
                 "models/kv_quant.py", "kernels/flash_attention.py",
                 "training/optimizer.py", "training/checkpoint.py",
                 "training/trainer.py", "data/dataset.py",
                 "core/scorer.py", "core/pipeline.py",
                 "launch/steps.py", "launch/train.py", "launch/serve.py",
                 "launch/artifacts.py", "launch/mesh.py",
                 "launch/shardings.py", "kernels/ref.py"):
        assert want in names


@pytest.mark.parametrize("path", _modules(),
                         ids=lambda p: p.relative_to(PORT).as_posix())
def test_no_jax_or_repro_import(path):
    assert _forbidden_imports(path) == []


def test_chip_smoke_imports_no_jax_or_repro():
    """The chip script runs on the card's machine, which has no jax."""
    assert _forbidden_imports(PORT.parent.parent / "chip_smoke.py") == []


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.models import init\n"
                   "from repro_torch.models import init as ok\n"
                   "import repro\nfrom . import sibling\n"
                   "from benchmarks.common import load_artifacts\n")
    assert [n for _, n in _forbidden_imports(src)] == [
        "jax.numpy", "repro.models", "repro", "benchmarks.common"]


def test_importing_every_module_loads_no_jax():
    mods = [".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("")
                     .parts).removesuffix(".__init__")
            for p in _modules()]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_nvcc_lookup_at_import():
    """Importing the kernels never builds: the build directory and nvcc
    are only touched on a first CUDA launch."""
    code = ("import shutil\n"
            "calls = []\n"
            "orig = shutil.which\n"
            "shutil.which = lambda *a, **k: calls.append(a) or orig(*a, **k)\n"
            "import repro_torch.kernels.ops\n"
            "import repro_torch.serving.engine\n"
            "import repro_torch.core, repro_torch.serving\n"
            "from repro_torch.kernels import ops, ref\n"
            "assert calls == [], calls\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
