"""The port's production dry run (``repro_torch.launch.dryrun``):
``model_flops`` and the training settings equal to the JAX package's for
every arch x shape; the sharding hooks of ``models.model`` (``act_spec``,
``kv_specs``) the identity on plain tensors, and on a fake mesh the
layouts they ask for; one full-width ``run_one`` record with the
reference's keys; the CLI; and the refusal to run over an open group."""
import importlib
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication)

from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import ALL_ARCHS  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro_torch.configs.base import kv_cache_specs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group,  # noqa: E402
                                     make_host_mesh)
from repro_torch.launch.spmd import SpmdRules  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.init import init_param_shapes, init_params  # noqa: E402


@pytest.fixture
def j_dryrun(monkeypatch):
    """The JAX package's dry-run module. Importing it prepends a
    512-device flag to ``XLA_FLAGS``: the variable is restored after the
    test, so later JAX tests on this worker see it as it was."""
    monkeypatch.setenv("XLA_FLAGS", "")
    return importlib.import_module("repro.launch.dryrun")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_equal_the_references(j_dryrun, arch):
    for shape in SHAPES.values():
        assert dryrun.model_flops(get_config(arch), shape) \
            == j_dryrun.model_flops(j_get_config(arch), shape), shape.name


def test_training_settings_are_the_references(j_dryrun):
    assert dryrun.TRAIN_MICROBATCHES == j_dryrun.TRAIN_MICROBATCHES
    assert dryrun.TRAIN_MOMENT_DTYPE == j_dryrun.TRAIN_MOMENT_DTYPE
    assert dryrun.TRAIN_ACCUM_DTYPE == j_dryrun.TRAIN_ACCUM_DTYPE


# ---------------------------------------------------------------------------
# the hooks: the identity on plain tensors
# ---------------------------------------------------------------------------

HOOK = (Shard(0), Replicate())        # any placements: plain tensors ignore


def _hooks(cfg):
    kv = {"kv": HOOK, "mla": HOOK, "ssm": HOOK, "conv": HOOK}
    if cfg.uses_moe:
        kv["moe_experts"] = {"w_gate": HOOK, "w_up": HOOK, "w_down": HOOK}
        kv["moe_ex_in"] = HOOK
    return kv


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return torch.equal(a, b)


def _decode_cache(cfg, B, cap):
    cache = {}
    la = len(cfg.attention_layer_ids())
    if cfg.use_mla:
        cache["kv_cache"] = torch.zeros(
            la, B, cap, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    elif la:
        for k in ("k_cache", "v_cache"):
            cache[k] = torch.zeros(la, B, cap, cfg.num_kv_heads,
                                   cfg.head_dim)
    if cfg.arch_type in ("ssm", "hybrid"):
        cache["ssm_state"] = torch.zeros(cfg.num_layers, B, cfg.ssm_heads,
                                         cfg.ssm_head_dim,
                                         cfg.ssm_state_size)
        cache["conv_state"] = torch.zeros(
            cfg.num_layers, B, cfg.ssm_conv_width - 1,
            cfg.d_inner + 2 * cfg.ssm_state_size)
    return {k: v.to(torch.bfloat16) if k != "ssm_state" else v
            for k, v in cache.items()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b",
                                  "mamba2-2.7b", "deepseek-v2-236b"])
def test_hooks_are_the_identity_on_plain_tensors(arch):
    """``forward_full``, ``lm_loss`` and ``serve_decode_step`` give the same
    bits with the hooks as without them."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                         dtype=torch.int32)
    hooks = _hooks(cfg)
    a = M.forward_full(params, cfg, toks, return_kv=True)
    b = M.forward_full(params, cfg, toks, return_kv=True, act_spec=HOOK,
                       kv_specs=hooks)
    assert _equal(a, b)
    labels = torch.roll(toks, -1, dims=1)
    assert torch.equal(
        M.lm_loss(params, cfg, toks, labels, remat=True),
        M.lm_loss(params, cfg, toks, labels, remat=True, act_spec=HOOK,
                  kv_specs=hooks))
    pos = torch.tensor([3, 7], dtype=torch.int32)
    outs = [M.serve_decode_step(params, cfg, toks[:, :1], pos,
                                _decode_cache(cfg, 2, 16), kv_specs=kv)
            for kv in (None, hooks)]
    assert _equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the hooks on a fake (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh():
    with fake_process_group(4):
        yield make_host_mesh(2, 2)
    assert not dist.is_initialized()


def _replicated(mesh, tree):
    if isinstance(tree, dict):
        return {k: _replicated(mesh, v) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, [Replicate(), Replicate()])


def test_forward_hooks_lay_out_the_residual_and_kv(mesh, monkeypatch):
    """Each layer's output (the residual) takes ``act_spec`` and its
    emitted K/V take ``kv_specs["kv"]``."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = _replicated(mesh, init_param_shapes(cfg))
    toks = distribute_tensor(torch.empty(4, 16, dtype=torch.int32,
                                         device="meta"),
                             mesh, [Shard(0), Replicate()])
    act, kv = (Shard(0), Shard(2)), (Shard(0), Shard(2))
    seen = []
    block = M._attn_block_full

    def spy(*args, **kwargs):
        h, k_v, aux = block(*args, **kwargs)
        seen.append((h.placements, k_v[0].placements, k_v[1].placements))
        return h, k_v, aux

    monkeypatch.setattr(M, "_attn_block_full", spy)
    with implicit_replication(), SpmdRules():
        out = M.forward_full(params, cfg, toks, return_kv=True,
                             act_spec=act, kv_specs={"kv": kv})
    assert seen == [(act, kv, kv)] * cfg.num_layers
    assert out["kvs"][0].placements == (Shard(1), Shard(3))   # stacked


def test_decode_hooks_lay_out_each_layers_entry(mesh, monkeypatch):
    """``serve_decode_step`` hands each layer its cache entry laid out by
    ``kv_specs["kv"]``, and the cache keeps its own layout."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = _replicated(mesh, init_param_shapes(cfg))
    cache_pl = [Shard(1), Shard(4)]
    cache = {k: distribute_tensor(torch.empty(2, 4, 16, 2, 64,
                                              dtype=torch.bfloat16,
                                              device="meta"), mesh, cache_pl)
             for k in ("k_cache", "v_cache")}
    toks = distribute_tensor(torch.empty(4, 1, dtype=torch.int32,
                                         device="meta"),
                             mesh, [Shard(0), Replicate()])
    pos = distribute_tensor(torch.empty(4, dtype=torch.int32, device="meta"),
                            mesh, [Shard(0), Replicate()])
    kv = (Shard(0), Shard(2))
    seen = []
    hook = M._kv_hook

    def spy(specs, key, x):
        out = hook(specs, key, x)
        seen.append((key, out.placements))
        return out

    monkeypatch.setattr(M, "_kv_hook", spy)
    with implicit_replication(), SpmdRules():
        out = M.serve_decode_step(params, cfg, toks, pos, cache,
                                  kv_specs={"kv": kv})
    assert seen == [("kv", kv)] * (2 * cfg.num_layers)
    assert all(out["cache"][k].placements == tuple(cache_pl)
               for k in ("k_cache", "v_cache"))


# ---------------------------------------------------------------------------
# run_one and the CLI
# ---------------------------------------------------------------------------

REFERENCE_KEYS = {
    "arch", "shape", "mesh", "status", "reason", "chips",
    "hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_bytes_per_dev",
    "collective_breakdown", "model_flops_global", "useful_flops_ratio",
    "score_bytes_per_dev", "t_memory_flash_proj_s", "t_compute_s",
    "t_memory_s", "t_collective_s", "dominant", "temp_size_in_bytes",
    "argument_size_in_bytes", "output_size_in_bytes", "per_device_hbm_gib"}


def test_run_one_at_full_width():
    """qwen3-4b-thinking's decode_32k over the 256-rank mesh: ``ok``, with
    the reference's keys (``trace_s`` for ``lower_s``/``compile_s``), the
    arguments' bytes from their layouts, and per-device flops above the
    model's share."""
    rec = dryrun.run_one("qwen3-4b-thinking", "decode_32k", False,
                         save=False)
    assert rec["status"] == "ok", rec.get("reason")
    assert REFERENCE_KEYS | {"trace_s"} <= set(rec)
    assert not {"lower_s", "compile_s", "generated_code_size_in_bytes",
                "cpu_f32_upcast_bytes_est",
                "per_device_hbm_gib_tpu_adj"} & set(rec)
    assert rec["chips"] == 256
    cfg = get_config("qwen3-4b-thinking")
    mesh = {"data": 16, "model": 16}
    params = init_param_shapes(cfg)
    want = (shd.sharded_bytes_per_device(
        params, shd.partition_params(cfg, mesh, params), mesh)
        + shd.sharded_bytes_per_device(
            dryrun.input_specs(cfg, "decode_32k"),
            shd.partition_inputs(cfg, mesh, "decode_32k"), mesh)
        + shd.sharded_bytes_per_device(
            kv_cache_specs(cfg, "decode_32k"),
            shd.partition_cache(cfg, mesh, "decode_32k"), mesh))
    assert rec["argument_size_in_bytes"] == want
    assert rec["hlo_flops_per_dev"] * 256 >= rec["model_flops_global"]
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert math.isclose(rec["t_memory_s"],
                        rec["hlo_bytes_per_dev"] / 3.35e12)
    assert not dist.is_initialized()


def test_cli_writes_records_and_skips(tmp_path, monkeypatch, capsys):
    """``--shape long_500k``: one record, written under the output dir;
    a dense arch without a long-context window skips it, as the
    reference does."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k"]) == 0
    assert "dry-run: 1 ok, 0 fail, 0 skip of 1" in capsys.readouterr().out
    assert (tmp_path / "qwen3-1.7b__long_500k__pod16x16.json").exists()
    import dataclasses
    short = dataclasses.replace(get_config("qwen3-1.7b"),
                                long_context_window=None)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: short)
    rec = dryrun.run_one("qwen3-1.7b", "long_500k", False, save=False)
    assert rec["status"] == "skip" and "unsupported" in rec["reason"]


def test_run_one_refuses_over_an_open_group():
    with fake_process_group(4):
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.run_one("qwen3-1.7b", "decode_32k", False, save=False)
    assert not dist.is_initialized()


def test_no_process_group_left_open():
    assert not dist.is_initialized()
