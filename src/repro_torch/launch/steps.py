"""Step functions of the launchers: train / prefill / serve-decode, ported
from ``repro/launch/steps.py``. They wrap the same model code the engine
and the trainer run, over explicit batches and caches.

A step updates its tensors in place where the JAX package returned new
ones from donated buffers: the train step the params and the AdamW
moments, the decode step its contiguous cache.

The sharding hooks ``act_spec`` and ``kv_specs`` (placements; see
``models.model.forward_full``) are passed through to the model, as the
JAX package's steps pass theirs: the production dry run
(``launch.dryrun``) runs these steps over DTensors with them. On plain
tensors they change nothing.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward_full, lm_loss, serve_decode_step
from repro_torch.training import tree as T
from repro_torch.training.optimizer import AdamW, local_shard

FRONTEND_KEYS = ("modality_embeds", "encoder_embeds")


def _rows(x: torch.Tensor, i: int, k: int) -> torch.Tensor:
    """Microbatch ``i`` of ``k`` of a batch ``x``: its i-th block of rows.
    A DTensor batch takes the i-th block of each rank's own rows, as data
    parallelism splits it (the blocks are other rows than the plain
    path's, of the same size, so the mean loss and summed gradients are
    the same up to rounding). A rank that holds fewer rows than there
    are microbatches gives each microbatch one of its rows, row
    ``i * n // k``: XLA pads a microbatch whose rows do not divide the
    batch's ranks to one row on each, and each rank computes that one."""
    rows = local_shard(x)
    n = rows.shape[0]
    lo, hi = i * n // k, (i + 1) * n // k
    if rows is x:
        return x[lo:hi]
    return type(x).from_local(rows[lo:max(hi, lo + 1)], x.device_mesh,
                              x.placements, run_check=False)


def make_train_step(cfg: ModelConfig, lr: float = 1e-4,
                    microbatches: int = 1,
                    moment_dtype: str = "float32",
                    accum_dtype: str = "float32",
                    act_spec=None, kv_specs=None
                    ) -> Tuple[Callable, AdamW]:
    """Full training step: forward (each layer checkpointed) + backward +
    one AdamW update. Returns ``(train_step, opt)`` with
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``;
    ``batch`` holds ``tokens``, ``labels`` [B, S] and, where the arch
    takes them, ``modality_embeds`` / ``encoder_embeds``.

    ``microbatches = k > 1`` accumulates gradients: the batch splits into
    k contiguous row blocks, run one after another; each block's
    gradients are added to the running sum in f32 and stored in
    ``accum_dtype``, the sum is divided by k in f32, and the loss is the
    mean of the k losses. That bounds the activation memory by one
    block's. The params are updated in place and left with
    ``requires_grad`` off."""
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                moment_dtype=moment_dtype)
    adt = getattr(torch, accum_dtype)

    def loss_and_grads(params, leaves, batch):
        loss = lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       remat=True, act_spec=act_spec, kv_specs=kv_specs,
                       **{k: batch[k] for k in FRONTEND_KEYS if k in batch})
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def accumulate(params, leaves, batch):
        k = microbatches
        B = batch["tokens"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} does not split into {k} "
                             f"microbatches")
        acc = [torch.zeros_like(p, dtype=adt) for p in leaves]
        losses = []
        for i in range(k):
            loss, grads = loss_and_grads(
                params, leaves,
                {key: _rows(v, i, k) for key, v in batch.items()})
            for a, g in zip(acc, grads):
                if a.dtype == torch.float32:
                    a.add_(g)   # the same f32 sum, without temporaries
                else:
                    a.copy_(a.float() + g.float())
            losses.append(loss)
            del grads
        # the mean in f32 (in place where the sum is already f32)
        return (torch.stack(losses).mean(),
                [a.div_(k) if a.dtype == torch.float32 else a.float() / k
                 for a in acc])

    def train_step(params, opt_state, batch):
        leaves = T.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if microbatches == 1:
                loss, grads = loss_and_grads(params, leaves, batch)
            else:
                loss, grads = accumulate(params, leaves, batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        params, opt_state = opt.update(T.unflatten(params, list(grads)),
                                       opt_state, params)
        return params, opt_state, loss

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, act_spec=None,
                      kv_specs=None) -> Callable:
    """Prefill: the full forward over the prompt, returning the last
    position's logits (to sample the first token) and the K/V or end
    state that seeds decode (``models.model.write_contiguous_kv``)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        out = forward_full(params, cfg, batch["tokens"], return_kv=True,
                           act_spec=act_spec, kv_specs=kv_specs,
                           **{k: batch[k] for k in FRONTEND_KEYS
                              if k in batch})
        return {"next_logits": out["logits"][:, -1], "kvs": out["kvs"]}

    return prefill_step


def make_decode_step(cfg: ModelConfig, kv_specs=None) -> Callable:
    """One decode step over the contiguous cache (updated in place):
    returns the greedy next token [B] int32, the STEP scorer's hidden
    state [B, D], the logits [B, Vp] it was drawn from, and the cache."""

    @torch.no_grad()
    def decode_fn(params, batch, cache):
        out = serve_decode_step(params, cfg, batch["tokens"],
                                batch["positions"], cache,
                                kv_specs=kv_specs)
        next_tok = out["logits"].argmax(dim=-1).to(torch.int32)
        return {"next_token": next_tok, "hidden": out["hidden"],
                "logits": out["logits"], "cache": out["cache"]}

    return decode_fn
