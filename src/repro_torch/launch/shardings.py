"""Sharding rules, ported from ``repro/launch/shardings.py``: the
training layout of the production dry run (params with FSDP, optimizer
moments, inputs and the contiguous decode caches) and the serving
layout of the mesh engine.

A spec is a tuple with one entry per tensor dim: the mesh axis that dim
is split over ("data" or "model"), a tuple of axes (``("pod", "data")``:
split over both, the first the major one), or ``None`` where the dim is
whole on every rank. That is the JAX package's ``PartitionSpec``, entry
for entry (a one-axis tuple is written as its name, as ``PartitionSpec``
normalises it). :func:`to_placements` turns a spec into DTensor
placements; :func:`local_slice` takes a rank's piece of a whole tensor
under a spec. Nothing here touches a device or a process group, except
:func:`to_placements`, which reads a ``DeviceMesh``; elsewhere ``mesh``
is a ``DeviceMesh`` or a mapping of axis name to size.

The training layout (the paper-faithful production config):

  * batch over ("pod", "data"): the pod axis carries only data
    parallelism;
  * tensor parallel over "model": column-parallel for the
    up-projections (``_MODEL_LAST``), row-parallel for the
    down-projections (``_MODEL_CONTRACT``), the Megatron pairing, so
    each attention or feed-forward block costs one all-reduce; experts
    over "model" where their count divides it;
  * FSDP over "data" on a second weight dim (always for training;
    for serving only past ``SERVE_FSDP_THRESHOLD_BYTES``).

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

import math
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, kv_cache_specs
from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.models.kv_quant import is_quantized

Spec = tuple

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


# ---------------------------------------------------------------------------
# training: the production layout of the dry run
# ---------------------------------------------------------------------------

# weight name -> the "model" axis shards its contraction (second-to-last)
# dim: the row-parallel half of the Megatron pairing
_MODEL_CONTRACT = {"wo", "w_down", "w_out"}
_REPLICATE = {"A_log", "D", "dt_bias", "b1", "b2"}

# serving adds FSDP over "data" only when the tensor-parallel shard of the
# params would exceed this (the JAX package's value, so that the layouts
# agree)
SERVE_FSDP_THRESHOLD_BYTES = 8 * 2 ** 30


def _entry(axes):
    """A spec entry over ``axes``: None, one axis's name, or a tuple of
    several (as ``PartitionSpec`` normalises a one-axis tuple)."""
    if axes is None:
        return None
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _pick_dim(shape, axis_n: int, used, prefer=None) -> Optional[int]:
    """First dim (``prefer`` first, then in order) that divides
    ``axis_n`` and is not in ``used``."""
    order = list(prefer) if prefer else []
    order += [d for d in range(len(shape)) if d not in order]
    for d in order:
        if d not in used and _div(shape[d], axis_n):
            return d
    return None


def param_spec(path: Tuple[str, ...], shape, mesh, fsdp: bool) -> Spec:
    """Spec of one parameter leaf at ``path`` (its dict keys) under the
    training layout: "model" on one dim (experts where their count
    divides it, the vocab rows of the embedding, the contraction dim of
    ``_MODEL_CONTRACT``, else the last dim that divides), and with
    ``fsdp`` "data" on the largest other dim that divides (never the
    layer-stack dim 0 of a stacked weight)."""
    name = _leaf_name(path)
    ndim = len(shape)
    model_n = axis_size(mesh, "model")
    data_n = axis_size(mesh, "data")
    spec = [None] * ndim
    used = set()
    if name in _REPLICATE or ndim < 2:
        return tuple(spec)
    if "experts" in path and ndim >= 3 and shape[-3] % model_n == 0:
        # expert parallelism: the E dim of [L, E, D, F] / [L, E, F, D]
        model_dim = ndim - 3
    elif name == "embed":
        model_dim = 0 if shape[0] % model_n == 0 else None
    elif name in _MODEL_CONTRACT:
        model_dim = _pick_dim(shape, model_n, used, prefer=[ndim - 2])
    else:   # _MODEL_LAST and any other matrix: the last dim first
        model_dim = _pick_dim(shape, model_n, used, prefer=[ndim - 1])
    if model_dim is not None:
        spec[model_dim] = "model"
        used.add(model_dim)
    if fsdp:
        sizes = sorted(((shape[d], d) for d in range(1 if ndim > 2 else 0,
                                                     ndim)
                        if d not in used), reverse=True)
        for size, d in sizes:
            if _div(size, data_n):
                spec[d] = "data"
                break
    return tuple(spec)


def _leaf_bytes(leaf) -> int:
    return math.prod(leaf.shape) * leaf.dtype.itemsize


def _leaf_pairs(tree, specs=None):
    """(leaf, spec) pairs of a tree of tensors (dicts, and tuples such as
    ``AdamState``) and its spec tree (None: no specs); a non-tensor leaf
    (the optimizer's step count) holds no bytes and is skipped."""
    if isinstance(tree, (dict, tuple)):
        keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
        for k in keys:
            yield from _leaf_pairs(tree[k], None if specs is None
                                   else specs[k])
    elif hasattr(tree, "shape"):
        yield tree, specs


def param_bytes(shapes_tree) -> int:
    """Bytes of every tensor of a tree (whole, on one device)."""
    return sum(_leaf_bytes(leaf) for leaf, _ in _leaf_pairs(shapes_tree))


def sharded_bytes_per_device(shapes_tree, spec_tree, mesh,
                             dtype_filter: Optional[torch.dtype] = None
                             ) -> int:
    """Bytes one device holds of a tree under its spec tree (of the
    leaves of ``dtype_filter`` only, when given)."""
    total = 0
    for leaf, spec in _leaf_pairs(shapes_tree, spec_tree):
        if dtype_filter is not None and leaf.dtype != dtype_filter:
            continue
        factor = 1
        for entry in spec:
            for a in _entry_axes(entry):
                factor *= axis_size(mesh, a)
        total += _leaf_bytes(leaf) // factor
    return total


def partition_params(cfg: ModelConfig, mesh, shapes_tree: dict,
                     fsdp: Optional[bool] = None) -> dict:
    """Spec tree of a param tree under the training layout. ``fsdp``
    None decides as the serving launcher does: FSDP when the params'
    tensor-parallel share exceeds ``SERVE_FSDP_THRESHOLD_BYTES``."""
    if fsdp is None:
        fsdp = (param_bytes(shapes_tree) / axis_size(mesh, "model")
                > SERVE_FSDP_THRESHOLD_BYTES)
    return _map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh, fsdp),
        shapes_tree)


def partition_opt_state(cfg: ModelConfig, mesh, opt_state, param_specs):
    """Spec tree of an ``AdamState``: each moment as its param under the
    training layout with FSDP (the step count is a scalar). As in the
    JAX package, ``param_specs`` is not read."""
    def moments(tree):
        return _map_with_path(
            lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh,
                                          fsdp=True), tree)
    return type(opt_state)(step=(), mu=moments(opt_state.mu),
                           nu=moments(opt_state.nu))


def _dp(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _batch_axes(mesh, batch: int):
    """The batch dim's entry: over the data axes where they divide
    ``batch``, else None."""
    dp = _dp(mesh)
    total = math.prod(axis_size(mesh, a) for a in dp)
    return _entry(dp) if batch % total == 0 else None


def partition_inputs(cfg: ModelConfig, mesh, shape_name: str) -> dict:
    """Specs matching ``configs.base.input_specs(cfg, shape_name)``."""
    shape = SHAPES[shape_name]
    dp = _batch_axes(mesh, shape.global_batch)
    specs = {"tokens": (dp, None)}
    if shape.kind == "train":
        specs["labels"] = (dp, None)
    elif shape.kind == "decode":
        specs["positions"] = (dp,)
    if cfg.modality == "vision" and shape.kind in ("train", "prefill"):
        specs["modality_embeds"] = (dp, None, None)
    if cfg.is_encoder_decoder and shape.kind in ("train", "prefill"):
        specs["encoder_embeds"] = (dp, None, None)
    return specs


def _model_dim_for_cache(shape, mesh, candidates) -> Optional[int]:
    model_n = axis_size(mesh, "model")
    for d in candidates:
        if _div(shape[d], model_n):
            return d
    return None


# cache key -> the dims "model" may take, in order (contiguous layout)
_CACHE_MODEL_DIMS = {"k_cache": (3, 2), "v_cache": (3, 2), "kv_cache": (2,),
                     "ssm_state": (2, 4), "conv_state": (3,),
                     "cross_k": (3, 4), "cross_v": (3, 4)}


def partition_cache(cfg: ModelConfig, mesh, shape_name: str) -> dict:
    """Specs matching ``configs.base.kv_cache_specs(cfg, shape_name)``:
    the batch dim over the data axes, and "model" on the heads where
    they divide it, else on the cache length (or the state's N, the conv
    channels): never on the head dim. Each data shard's sequences live
    wholly on it, so nothing gathers across shards."""
    dp = _batch_axes(mesh, SHAPES[shape_name].global_batch)
    out = {}
    for key, t in kv_cache_specs(cfg, shape_name).items():
        spec = [None] * t.dim()
        spec[1] = dp
        md = _model_dim_for_cache(t.shape, mesh, _CACHE_MODEL_DIMS[key])
        if md is not None:
            spec[md] = "model"
        out[key] = tuple(spec)
    return out


def kv_partition_specs(cfg: ModelConfig, mesh, batch: int) -> dict:
    """Specs of the PER-LAYER K/V and state that the model emits at
    prefill and carries at decode (the ``kv_specs`` hook of
    ``models.model``):

      kv   [B, S|cap, KVH, hd]     mla  [B, S|cap, lora+rope]
      ssm  [B, H, P, N]            conv [B, W-1, C]

    Batch over the data axes; "model" on the kv heads where they divide
    it, else on the sequence (scores contract the head dim, so a split
    head dim would gather the whole cache every step, while a split
    sequence needs only the softmax's small all-reduces); MLA's latent
    splits its sequence for the same reason; the state on its heads,
    else N."""
    model_n = axis_size(mesh, "model")
    dp = _batch_axes(mesh, batch)
    out = {}
    if cfg.num_kv_heads and cfg.head_dim:
        out["kv"] = ((dp, None, "model", None)
                     if _div(cfg.num_kv_heads, model_n)
                     else (dp, "model", None, None))
    if cfg.use_mla:
        out["mla"] = (dp, "model", None)
    if cfg.arch_type in ("ssm", "hybrid"):
        if _div(cfg.ssm_heads, model_n):
            out["ssm"] = (dp, "model", None, None)
        elif _div(cfg.ssm_state_size, model_n):
            out["ssm"] = (dp, None, None, "model")
        else:
            out["ssm"] = (dp, None, None, None)
        C = cfg.d_inner + 2 * cfg.ssm_state_size
        out["conv"] = (dp, None, "model" if _div(C, model_n) else None)
    return out


def moe_expert_specs(cfg: ModelConfig, mesh) -> Optional[dict]:
    """FSDP-free specs of one layer's expert weights ([E, D, F] /
    [E, F, D]): experts over "model" where E divides it, else the ffn
    dim, else whole. Constraining the weights to these before the group
    loop gathers them once per layer, not once per chunk of groups."""
    if not cfg.uses_moe:
        return None
    model_n = axis_size(mesh, "model")
    if _div(cfg.num_experts, model_n):
        return {"w_gate": ("model", None, None),
                "w_up": ("model", None, None),
                "w_down": ("model", None, None)}
    if _div(cfg.moe_d_ff, model_n):
        return {"w_gate": (None, None, "model"),
                "w_up": (None, None, "model"),
                "w_down": (None, "model", None)}
    return {"w_gate": (None, None, None), "w_up": (None, None, None),
            "w_down": (None, None, None)}


def moe_ex_in_spec(cfg: ModelConfig, mesh) -> Optional[Spec]:
    """Serving layout of the dispatched expert inputs [G, E, C, D]: E over
    "model" (as the expert-parallel weights), D over "data" (as their
    FSDP dim), so that activations move and the weights stay put."""
    if not cfg.uses_moe:
        return None
    e = "model" if cfg.num_experts % axis_size(mesh, "model") == 0 else None
    d = "data" if cfg.d_model % axis_size(mesh, "data") == 0 else None
    return (None, e, None, d)


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on the DeviceMesh ``mesh``: a mesh
    dim that entry d names becomes ``Shard(d)``, any other
    ``Replicate()``. A dim over several axes (``("pod", "data")``) is
    split over each of their mesh dims, the first the major one, in mesh
    order, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a in dim_of:
                raise ValueError(f"axis {a!r} named twice in {spec}")
            dim_of[a] = d
    names = axis_names(mesh)
    unknown = set(dim_of) - set(names)
    if unknown:
        raise ValueError(f"{spec} names {sorted(unknown)}, not axes of "
                         f"the mesh {names}")
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


# ---------------------------------------------------------------------------
# serving: the mesh engine's layout
# ---------------------------------------------------------------------------

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
