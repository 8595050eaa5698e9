"""Production dry run, ported from ``repro/launch/dryrun.py``: run every
(architecture x input shape) step once over the production meshes,
laid out as the JAX package lays it out, without the devices, and
count each device's share of the work and the roofline terms it gives.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape decode_32k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-4b-thinking --both-meshes

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``;
the exit code is 1 when any record failed.

Where the JAX package lowers and compiles each step on 512 simulated
host devices and parses the per-device HLO, the port starts a fake
process group of the mesh's rank count in this one process
(``launch.mesh.fake_process_group``), builds the params, optimizer
moments, inputs and caches as DTensors over ``meta`` local shards (no
storage) under the JAX package's layouts (``launch.shardings``), and
runs the step once under ``launch.cost_analysis.CostCounter``, which
counts rank 0's ops and collectives. Every number in a record is a
count at the H100's datasheet peaks, not a measurement.

A record has the reference's keys where they have a meaning here:
``hlo_flops_per_dev``, ``hlo_bytes_per_dev``, ``collective_bytes_per_dev``
and ``score_bytes_per_dev`` hold the counter's per-device numbers (there
is no HLO; the names are kept so the records read as the reference's),
``trace_s`` takes the place of ``lower_s``/``compile_s``,
``argument_size_in_bytes`` is the per-device bytes of the step's
arguments under their layouts, ``temp_size_in_bytes`` the peak of the
bytes that the step's own tensors held at once on rank 0, and
``output_size_in_bytes`` the local bytes of what the step returns.
Three fields have no counterpart and are left out:
``generated_code_size_in_bytes`` (nothing is compiled),
``cpu_f32_upcast_bytes_est`` and ``per_device_hbm_gib_tpu_adj`` (they
correct for XLA-CPU's f32 copies of bf16 weights, which the counter
never makes). ``all_to_all_from_all_gather`` and ``ops`` come from the
counter. A failure is the finding: its record holds the error, and
``op`` names the aten op DTensor could not shard.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, input_specs, kv_cache_specs
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.launch import shardings as shd
from repro_torch.launch.cost_analysis import HBM_BW, op_cost, roofline_terms
from repro_torch.launch.mesh import (fake_process_group, make_production_mesh,
                                     production_mesh_shape)
from repro_torch.launch.spmd import SpmdRules, wrap
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.init import init_param_shapes, padded_vocab
from repro_torch.training.optimizer import AdamState

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# Gradient-accumulation factors, moment and accumulator dtypes: the JAX
# package's values, so that the steps and layouts are its own. Archs not
# listed run the whole batch at once, with f32 moments and accumulator.
TRAIN_MICROBATCHES = {
    "granite-20b": 2,
    "mixtral-8x7b": 2,
    "deepseek-v2-236b": 16,
    "seamless-m4t-large-v2": 2,
    "zamba2-2.7b": 2,
}
TRAIN_MOMENT_DTYPE = {
    "deepseek-v2-236b": "bfloat16",
}
TRAIN_ACCUM_DTYPE = {
    "deepseek-v2-236b": "bfloat16",
}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D tokens (dense) / 6*N_active*D (MoE), where N
    counts ACTIVE non-embedding params and D = tokens processed."""
    D = cfg.d_model
    n = 0
    if cfg.arch_type in ("ssm", "hybrid"):
        di = cfg.d_inner
        Nn = cfg.ssm_state_size
        per_mamba = D * (2 * di + 2 * Nn + cfg.ssm_heads) + di * D \
            + cfg.ssm_conv_width * (di + 2 * Nn)
        n += cfg.num_layers * per_mamba
        if cfg.arch_type == "hybrid":
            attn = D * cfg.num_heads * cfg.head_dim * 2 \
                + 2 * D * cfg.num_kv_heads * cfg.head_dim \
                + 3 * D * cfg.d_ff
            n += (cfg.num_layers // cfg.hybrid_attn_every) * attn
    else:
        if cfg.use_mla:
            attn = (D * cfg.q_lora_rank
                    + cfg.q_lora_rank * cfg.num_heads
                    * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                    + D * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                    + cfg.kv_lora_rank * cfg.num_heads
                    * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                    + cfg.num_heads * cfg.v_head_dim * D)
        else:
            attn = D * cfg.num_heads * cfg.head_dim \
                + 2 * D * cfg.num_kv_heads * cfg.head_dim \
                + cfg.num_heads * cfg.head_dim * D
        if cfg.uses_moe:
            ff = 3 * D * cfg.moe_d_ff * (cfg.num_experts_per_tok
                                         + cfg.num_shared_experts)
        else:
            ff = 3 * D * cfg.d_ff
        n += cfg.num_layers * (attn + ff)
        if cfg.is_encoder_decoder:
            enc = cfg.num_encoder_layers * (attn + 3 * D * cfg.d_ff)
            n += enc + cfg.num_layers * attn  # cross attention
    n += D * padded_vocab(cfg)  # lm head
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _place(mesh, tree, specs):
    """The meta tensors of ``tree`` as DTensors laid out by ``specs``
    (their local shards on ``meta``: shapes, no storage)."""
    if isinstance(tree, dict):
        return {k: _place(mesh, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, AdamState):
        return AdamState(step=tree.step, mu=_place(mesh, tree.mu, specs.mu),
                         nu=_place(mesh, tree.nu, specs.nu))
    placements = shd.to_placements(mesh, specs)
    local = list(tree.shape)
    for mesh_dim, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(mesh_dim)
    return wrap(torch.empty(local, dtype=tree.dtype, device="meta"), mesh,
                placements, tree.shape)


def _placements(mesh, specs: dict) -> dict:
    """A ``kv_specs`` dict of specs (and a dict of them) as placements."""
    return {k: (_placements(mesh, v) if isinstance(v, dict)
                else shd.to_placements(mesh, v)) for k, v in specs.items()}


def build_step(cfg, shape_name: str, mesh):
    """``(step, args, argument bytes per device)`` for this cfg x shape:
    the launcher's step with the JAX package's sharding hooks, and its
    arguments as DTensors over ``mesh`` (the counterpart of the
    reference's ``build_lowerable``)."""
    shape = SHAPES[shape_name]
    base_name = cfg.name.split("-smoke")[0]
    params_shapes = init_param_shapes(cfg)
    in_shapes = input_specs(cfg, shape_name)
    in_specs = shd.partition_inputs(cfg, mesh, shape_name)
    dp = shd._entry(shd._dp(mesh))

    if shape.kind == "train":
        pspecs = shd.partition_params(cfg, mesh, params_shapes, fsdp=True)
        # no "moe_experts" hoist at train time, as in the JAX package
        step, opt = make_train_step(
            cfg, act_spec=shd.to_placements(mesh, (dp, None, "model")),
            microbatches=TRAIN_MICROBATCHES.get(base_name, 1),
            moment_dtype=TRAIN_MOMENT_DTYPE.get(base_name, "float32"),
            accum_dtype=TRAIN_ACCUM_DTYPE.get(base_name, "float32"))
        opt_shapes = opt.init(params_shapes)
        ospecs = shd.partition_opt_state(cfg, mesh, opt_shapes, pspecs)
        arg_bytes = (shd.sharded_bytes_per_device(params_shapes, pspecs,
                                                  mesh)
                     + shd.sharded_bytes_per_device(opt_shapes, ospecs, mesh)
                     + shd.sharded_bytes_per_device(in_shapes, in_specs,
                                                    mesh))
        args = (_place(mesh, params_shapes, pspecs),
                _place(mesh, opt_shapes, ospecs),
                _place(mesh, in_shapes, in_specs))
        return step, args, arg_bytes

    dp_ok = shd._batch_axes(mesh, shape.global_batch)
    kvsp = shd.kv_partition_specs(cfg, mesh, shape.global_batch)
    # MoE serving: the dispatched activations move to the stationary
    # expert weights
    exin = shd.moe_ex_in_spec(cfg, mesh)
    if exin is not None:
        kvsp["moe_ex_in"] = exin
    kv_pl = _placements(mesh, kvsp)
    pspecs = shd.partition_params(cfg, mesh, params_shapes)
    arg_bytes = (shd.sharded_bytes_per_device(params_shapes, pspecs, mesh)
                 + shd.sharded_bytes_per_device(in_shapes, in_specs, mesh))
    params = _place(mesh, params_shapes, pspecs)
    batch = _place(mesh, in_shapes, in_specs)
    if shape.kind == "prefill":
        step = make_prefill_step(
            cfg, act_spec=shd.to_placements(mesh, (dp_ok, None, "model")),
            kv_specs=kv_pl)
        return step, (params, batch), arg_bytes

    cache_shapes = kv_cache_specs(cfg, shape_name)
    cspecs = shd.partition_cache(cfg, mesh, shape_name)
    arg_bytes += shd.sharded_bytes_per_device(cache_shapes, cspecs, mesh)
    step = make_decode_step(cfg, kv_specs=kv_pl)
    return step, (params, batch, _place(mesh, cache_shapes, cspecs)), \
        arg_bytes


def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of the tensors of ``tree``."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def _failed_op(message: str):
    """The aten op a DTensor error names, if any."""
    m = re.search(r"\baten\.[\w.]+", message)
    return m.group(0) if m else None


def run_one(arch: str, shape_name: str, multi_pod: bool,
            save: bool = True) -> dict:
    """One dry-run record (see the module docstring). Raises
    ``RuntimeError`` when a default process group is already
    initialized: the dry run starts a fake one of the mesh's size."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "skip", "reason": None}

    if not cfg.supports_shape(shape):
        rec["reason"] = "unsupported shape (see DESIGN.md long_500k policy)"
        return rec
    if cfg.is_encoder_decoder and shape.kind == "decode" \
            and shape.name == "long_500k" \
            and cfg.long_context_window is None:
        rec["reason"] = "enc-dec without long-context window"
        return rec
    if dist.is_initialized():
        raise RuntimeError("the dry run starts a fake process group of the "
                           "mesh's size; a default group is already "
                           "initialized")

    from torch.distributed.tensor.experimental import implicit_replication
    sizes, _ = production_mesh_shape(multi_pod=multi_pod)
    chips = math.prod(sizes)
    t0 = time.time()
    try:
        with fake_process_group(chips):
            mesh = make_production_mesh(multi_pod=multi_pod)
            step, args, arg_bytes = build_step(cfg, shape_name, mesh)
            outs = []
            with implicit_replication(), SpmdRules():
                cost = op_cost(lambda *a: outs.append(step(*a)), *args,
                               score_seq_len=shape.seq_len
                               if shape.kind in ("train", "prefill")
                               else None)
            out_bytes = _local_bytes(outs)
            del outs, args
        t_trace = time.time() - t0
        flops, hbm_bytes = cost["flops"], cost["bytes"]
        terms = roofline_terms(flops, hbm_bytes, cost["collective_bytes"],
                               chips=1)
        mf = model_flops(cfg, shape)
        temp = cost["peak_live_bytes"]
        rec.update({
            "status": "ok",
            "chips": chips,
            "trace_s": round(t_trace, 2),
            "hlo_flops_per_dev": flops,
            "hlo_bytes_per_dev": hbm_bytes,
            "collective_bytes_per_dev": cost["collective_bytes"],
            "collective_breakdown": cost["collective_breakdown"],
            "all_to_all_from_all_gather":
                cost["all_to_all_from_all_gather"],
            "ops": cost["ops"],
            "model_flops_global": mf,
            "useful_flops_ratio": (mf / (flops * chips)) if flops else None,
            "score_bytes_per_dev": cost["score_bytes"],
            "t_memory_flash_proj_s": (hbm_bytes - cost["score_bytes"])
            / HBM_BW,
            **terms,
            "temp_size_in_bytes": temp,
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "per_device_hbm_gib": round((arg_bytes + temp) / 2 ** 30, 3),
        })
    except Exception as e:  # noqa: BLE001 — a failure here IS the finding
        rec["status"] = "fail"
        rec["reason"] = " ".join([f"{type(e).__name__}: {e}",
                                  *getattr(e, "__notes__", [])])
        rec["op"] = _failed_op(rec["reason"])
        rec["traceback"] = traceback.format_exc()[-2000:]
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_one(arch, shape, mp)
                results.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f"dom={rec['dominant']} "
                             f"hbm={rec['per_device_hbm_gib']}GiB "
                             f"trace={rec['trace_s']}s")
                elif rec.get("reason"):
                    extra = rec["reason"][:90]
                print(f"[{rec['mesh']}] {arch:24s} {shape:12s} "
                      f"{status:5s} {extra}", flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_fail} fail, {n_skip} skip "
          f"of {len(results)}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
