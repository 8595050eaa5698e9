"""The port's launchers as a user runs them, on the CPU (``--device
cpu``):

- ``repro_torch.launch.train`` writes a checkpoint that the JAX
  package's ``load_pytree`` reads against its own ``init_params``;
- ``repro_torch.launch.serve`` on artifacts written by the JAX
  package's ``save_pytree``, offline and in the batched, streamed,
  int8-pool, multi-tenant, deadline and fault-injection modes, printing
  the JAX launcher's summary lines;
- the paper's claim under the tight pool of ``--blocks 12``: STEP
  prunes and never waits, SC preempts and waits;
- ``--mesh`` on four gloo ranks of the CPU: rank 0 prints the
  single-device summary, the other ranks print nothing, and a mesh the
  ranks do not fill exits with the validation message; without a
  process group ``--mesh`` exits before anything loads, and the default
  device raises without a card.
"""
import re

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.training import checkpoint as j_ckpt  # noqa: E402
from repro_torch.launch import artifacts, serve, train  # noqa: E402
import torch_mesh_ranks as R  # noqa: E402

SUMMARY = re.compile(r"^\[(\w+)\] acc=\d\.\d\d tokens=\d+ latency=\d+\.\d\ds "
                     r"wait=\d+\.\d\ds pruned=\d+ preempt=\d+$", re.M)
SERVING = re.compile(r"^\[serving\] ttft p50=\d+\.\d\ds p99=\d+\.\d\ds \| "
                     r"tpot p50=\d+ms \| e2e p50=\d+\.\d\ds "
                     r"p99=\d+\.\d\ds \| throughput=\d+\.\d tok/s$", re.M)
BASE = ["--problems", "2", "--traces", "4", "--max-new", "24",
        "--device", "cpu"]


def test_train_cli_checkpoint_loads_in_jax(tmp_path, capsys):
    path = str(tmp_path / "model.npz")
    hist = train.main(["--smoke", "--steps", "3", "--batch", "4", "--seq",
                       "32", "--microbatches", "2", "--save", path,
                       "--device", "cpu"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "[train] arch=qwen3-4b-thinking-smoke" in out
    assert f"[train] saved to {path}" in out
    jcfg = j_get_config("qwen3-4b-thinking", smoke=True)
    like = j_init_params(jcfg, jax.random.PRNGKey(0))
    loaded = j_ckpt.load_pytree(path, like)
    leaves = jax.tree_util.tree_leaves(loaded)
    assert [x.shape for x in leaves] == \
        [x.shape for x in jax.tree_util.tree_leaves(like)]
    assert all(x.dtype == y.dtype for x, y in
               zip(leaves, jax.tree_util.tree_leaves(like)))
    assert all(np.isfinite(np.asarray(x, np.float32)).all() for x in leaves)


@pytest.fixture(scope="module")
def art_dir(tmp_path_factory):
    """The serving artifacts as the JAX package writes them: its bf16
    init of the serving config and a scorer, through its save_pytree."""
    d = tmp_path_factory.mktemp("artifacts")
    jcfg = j_serving_config()
    j_ckpt.save_pytree(str(d / "model.npz"),
                       j_init_params(jcfg, jax.random.PRNGKey(0)))
    j_ckpt.save_pytree(str(d / "scorer.npz"),
                       j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model))
    return str(d)


@pytest.fixture
def run(art_dir, monkeypatch, capsys):
    monkeypatch.setattr(artifacts, "ART_DIR", art_dir)

    def run(*argv):
        capsys.readouterr()
        res = serve.main(list(argv))
        return res, capsys.readouterr().out
    return run


def test_load_artifacts_reads_jax_files(run):
    params, scorer, cfg = artifacts.load_artifacts(device="cpu")
    jp = j_init_params(j_serving_config(), jax.random.PRNGKey(0))
    want = np.asarray(jp["embed"], np.float32)
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(), want)
    assert scorer["w1"].shape == (cfg.d_model, 512)


@pytest.mark.parametrize("mode,extra,lines", [
    ("offline", [], []),
    ("online", ["--batched", "--stream", "--arrival-rate", "50", "--chunk",
                "8", "--max-tokens-per-step", "32"], [SERVING]),
    ("int8", ["--kv-dtype", "int8", "--chunk", "8", "--use-kernel", "on"],
     []),
    ("tenants", ["--tenant-weights", "premium:3,batch:1", "--slo", "30,5"],
     [SERVING, re.compile(r"^\[slo\] requests=2 ttft_attainment=\d\.\d\d "
                          r"tpot_attainment=\S+ degraded_traces=\d+$",
                          re.M)]),
    ("deadline", ["--deadline", "0"],
     [re.compile(r"^\[faults\] cancelled=0 deadline_exceeded=2 failed=0 "
                 r"failed_traces=0$", re.M)]),
    ("faults", ["--faults", "step@2x3,alloc@5,nan@7:slot=1"], [SERVING]),
])
def test_serve_cli_modes(run, mode, extra, lines):
    res, out = run("--method", "step", *BASE, *extra)
    assert SUMMARY.search(out).group(1) == "step"
    for pat in lines:
        assert pat.search(out), (mode, out)
    assert len(res.per_problem) == 2
    if mode == "online":
        assert len(re.findall(r"^  << q\d done: ", out, re.M)) == 2
    if mode == "offline":
        assert res.serving is None and "[serving]" not in out
        assert len(re.findall(r"^  \[step\] q\d: ans=", out, re.M)) == 2


def test_tight_pool_step_prunes_sc_preempts(run):
    """``--blocks 12`` under 16 traces: 11 blocks for the traces' private
    pages. STEP prunes the lowest-scored traces and nothing waits; SC
    preempts and its traces wait."""
    tight = ["--problems", "1", "--traces", "16", "--blocks", "12",
             "--max-new", "48", "--device", "cpu"]
    step, _ = run("--method", "step", *tight)
    assert step.num_pruned > 0
    assert step.total_wait_s == 0.0 and step.num_preemptions == 0
    sc, out = run("--method", "sc", *tight)
    assert sc.num_preemptions > 0 and sc.total_wait_s > 0
    assert SUMMARY.search(out).group(1) == "sc"


@pytest.mark.parametrize("spec", ["2,2", "auto"])
def test_mesh_without_a_process_group_exits_before_loading(spec, tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(artifacts, "ART_DIR", str(tmp_path / "none"))
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node"):
        serve.main(["--mesh", spec, "--device", "cpu"])
    with pytest.raises(SystemExit, match="DATA,MODEL"):
        serve.main(["--mesh", "2x2", "--device", "cpu"])
    assert not (tmp_path / "none").exists()
    assert serve.parse_mesh(None) is None and serve.parse_mesh("none") is None


@pytest.fixture(scope="module")
def mesh_cli(art_dir, tmp_path_factory):
    """Each rank's output of the serve CLI on four gloo ranks: a 2x2 mesh
    serve, and a 3x2 mesh the four ranks cannot fill."""
    path = tmp_path_factory.mktemp("mesh_cli")
    argv = ["--method", "step", *BASE, "--mesh", "2,2"]
    ranks = R.spawn(4, str(path), "serve_cli", art_dir,
                    [argv, ["--mesh", "3,2", "--device", "cpu"]])
    return argv, [r[0] for r in ranks], [r[1] for r in ranks]


def _fields(line):
    """The summary line's fields that do not depend on time."""
    return {k: v for k, v in re.findall(r"(\w+)=(\S+)", line)
            if k not in ("latency", "wait")}


def test_mesh_cli_rank0_prints_the_single_device_summary(run, mesh_cli):
    argv, ok, _ = mesh_cli
    _, single = run(*argv[:-2])
    line = SUMMARY.search(single).group(0)
    out = ok[0]["stdout"]
    assert ok[0]["exit"] is None
    assert _fields(SUMMARY.search(out).group(0)) == _fields(line)
    assert len(re.findall(r"^  \[step\] q\d: ans=", out, re.M)) == 2
    for rank in ok[1:]:
        assert rank["stdout"] == "" and rank["exit"] is None


def test_mesh_cli_exits_on_a_mesh_the_ranks_do_not_fill(mesh_cli):
    for rank in mesh_cli[2]:
        assert rank["exit"].startswith("--mesh 3,2: mesh axis data=3 does "
                                       "not divide the 4 available device")


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(artifacts, "ART_DIR", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--problems", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    assert not (tmp_path / "none").exists()
