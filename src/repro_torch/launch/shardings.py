"""Sharding rules of the serving mesh (the serving half of
``repro/launch/shardings.py``; its training half, with FSDP and the
production meshes, comes with the dry run, ROADMAP A).

A spec is a tuple with one entry per tensor dim: the mesh axis that dim
is split over ("data" or "model"), or ``None`` where the dim is whole on
every rank. That is the JAX package's ``PartitionSpec``, entry for entry;
:func:`local_slice` takes a rank's piece of a whole tensor under a spec.
Nothing here touches a device or a process group: ``mesh`` is a
``DeviceMesh`` or a mapping of axis name to size.

The serving layout trades part of the tensor-parallel memory win for
EXACTNESS. The column-parallel weights shard their output dim over
"model"; the row-parallel contraction weights (``wo``, ``w_down``,
``w_out``) and every norm scale stay whole, so the only collectives a
rank makes are all-gathers of activations: pure data movement, never a
floating-point reduction. The mesh engine's logits are then the
single-device engine's, bit for bit where the local products are
(docs/ENGINE.md "Sharded serving").
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.models.kv_quant import is_quantized

Spec = Tuple[Optional[str], ...]

# weight name -> the "model" axis shards its output (last) dim
_MODEL_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "wq_a", "wq_b", "wkv_a",
               "wk_b", "wv_b", "router", "w_in", "lm_head", "conv_w"}


def _div(n: int, axis_n: int) -> bool:
    return n >= axis_n and n % axis_n == 0


def _leaf_name(path: Tuple[str, ...]) -> str:
    return path[-1] if path else ""


def _map_with_path(fn, tree: dict, path: Tuple[str, ...] = ()) -> dict:
    return {k: (_map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in tree.items()}


def serving_param_specs(cfg: ModelConfig, mesh, shapes_tree: dict) -> dict:
    """Spec tree for the serving params (``shapes_tree``: the params, or
    anything with the same keys and ``.shape`` leaves). Only the
    column-parallel set (``_MODEL_LAST``, on its output dim) and the
    embedding's vocab dim shard over "model", and only when that dim
    divides the axis; everything else is whole on every rank. No FSDP:
    "data" carries the trace batch."""
    model_n = axis_size(mesh, "model")

    def one(path, leaf) -> Spec:
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        name = _leaf_name(path)
        if not shape:
            return ()
        if name == "embed" and _div(shape[0], model_n):
            spec[0] = "model"   # vocab rows: a masked lookup, then a gather
        elif name in _MODEL_LAST and len(shape) >= 2 \
                and _div(shape[-1], model_n):
            spec[-1] = "model"  # column-parallel output dim
        return tuple(spec)

    return _map_with_path(one, shapes_tree)


def serving_cache_specs(cfg: ModelConfig, mesh,
                        kv_dtype: str = "bf16") -> dict:
    """Specs of the engine's paged decode cache (``init_decode_cache``
    keys, block tables aside: they are host state). The pools
    ``[L, NB, bs, KVH, hd]`` shard their kv heads over "model" where they
    divide it, and keep every block on every data rank, so any lane
    reads any block locally and the host allocator stays global; a
    quantized pool's scales ``[L, NB, bs, KVH]`` shard as their pool.
    MLA's latent pool is whole; per-slot recurrent state and cross caches
    shard their batch dim over "data" (the layout of archs the mesh
    engine still refuses, kept from the reference)."""
    model_n = axis_size(mesh, "model")
    out: dict = {}
    if cfg.attention_layer_ids():
        if cfg.use_mla:
            out["kv_pool"] = (None, None, None, None)
        else:
            kvh = "model" if _div(cfg.num_kv_heads, model_n) else None
            out["k_pool"] = (None, None, None, kvh, None)
            out["v_pool"] = (None, None, None, kvh, None)
            if is_quantized(kv_dtype):
                out["k_scale"] = (None, None, None, kvh)
                out["v_scale"] = (None, None, None, kvh)
    if cfg.arch_type in ("ssm", "hybrid"):
        out["ssm_state"] = (None, "data", None, None, None)
        out["conv_state"] = (None, "data", None, None)
    if cfg.is_encoder_decoder:
        kvh = "model" if _div(cfg.num_kv_heads, model_n) else None
        out["cross_k"] = (None, "data", None, kvh, None)
        out["cross_v"] = (None, "data", None, kvh, None)
    return out


def serving_prefill_kv_specs(cfg: ModelConfig, mesh) -> dict:
    """Specs of the per-layer K/V and state a batch-1 prefill emits
    (``forward_full(return_kv=True)``): kv heads as the pools hold them,
    so the pool scatter stays local."""
    model_n = axis_size(mesh, "model")
    out = {}
    if cfg.num_kv_heads and cfg.head_dim:
        kvh = "model" if _div(cfg.num_kv_heads, model_n) else None
        out["kv"] = (None, None, kvh, None)
    if cfg.use_mla:
        out["mla"] = (None, None, None)
    if cfg.arch_type in ("ssm", "hybrid"):
        out["ssm"] = (None, None, None, None)
        out["conv"] = (None, None, None)
    return out


def serving_step_shardings(cfg: ModelConfig, mesh,
                           kv_dtype: str = "bf16") -> dict:
    """The spec bundle of the mesh engine's steps:

      lane        [B]        trace-batch state over "data"
      table       [B, ...]   block tables, per-lane [B, K] outputs
      hidden      [B, D]     last hidden state: the scorer runs on a
                             rank's own lanes
      act         [B, 1, *]  decode activations before a row contraction
                             (the gather points)
      prefill_act [1, S, *]  the same for batch-1 prefills
      pools       the stacked cache (serving_cache_specs)
      layer_pool  one layer's slice of it
      replicated  generator state, scorer params, prefill logits
    """
    cache = serving_cache_specs(cfg, mesh, kv_dtype)
    return {
        "lane": ("data",),
        "table": ("data", None),
        "hidden": ("data", None),
        "act": ("data", None, None),
        "prefill_act": (None, None, None),
        "pools": dict(cache),
        "layer_pool": {k: s[1:] for k, s in cache.items()},
        "replicated": (),
    }


def mesh_coords(mesh) -> dict:
    """This rank's coordinate on each axis of a DeviceMesh."""
    return {name: mesh.get_local_rank(name) for name in axis_names(mesh)}


def local_slice(x: torch.Tensor, spec: Spec, mesh,
                coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """The piece of the whole tensor ``x`` that the rank at ``coords``
    (default: this rank's place on the DeviceMesh ``mesh``) holds under
    ``spec``: a view, an equal share of each split dim."""
    if coords is None:
        coords = mesh_coords(mesh)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axis}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, coords[axis] * size, size)
    return x
