"""LM training loop, ported from ``repro/training/trainer.py`` (the
quickstart and the end-to-end pipeline train the tiny reasoning model the
serving benchmarks sample from). The step is ``torch.autograd`` over the
dense attention path, as the JAX package's is over its jnp path: the
flash-attention kernel has no backward."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.init import init_params
from repro_torch.models.model import lm_loss
from repro_torch.training import tree as T
from repro_torch.training.optimizer import AdamW, cosine_schedule


@dataclasses.dataclass
class TrainConfig:
    steps: int = 300
    seq_len: int = 256
    batch_size: int = 16
    peak_lr: float = 3e-3
    warmup: int = 30
    weight_decay: float = 0.01
    log_every: int = 25
    seed: int = 0


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    use_kernel: bool = False) -> Callable:
    """``train_step(params, opt_state, tokens, labels) -> (params,
    opt_state, loss)``: one AdamW step on the LM loss, params and moments
    updated in place."""
    def train_step(params, opt_state, tokens, labels):
        leaves = T.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = lm_loss(params, cfg, tokens, labels, use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, leaves)
        params, opt_state = opt.update(T.unflatten(params, grads),
                                       opt_state, params)
        return params, opt_state, loss.detach()
    return train_step


def train_lm(cfg: ModelConfig, tcfg: Optional[TrainConfig] = None,
             batches=None, verbose: bool = True, device=None):
    """Train from scratch on the synthetic reasoning task, on CUDA unless
    ``device`` names the CPU; the init draws from a ``torch.Generator``
    seeded with ``tcfg.seed``. Returns (params, history)."""
    from repro_torch.data.dataset import lm_batches
    tcfg = tcfg or TrainConfig()
    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        tcfg.seed))
    opt = AdamW(learning_rate=cosine_schedule(
        tcfg.peak_lr, tcfg.warmup, tcfg.steps),
        weight_decay=tcfg.weight_decay)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    if batches is None:
        batches = lm_batches(tcfg.seq_len, tcfg.batch_size, seed=tcfg.seed)

    history = []
    t0 = time.time()
    for step in range(tcfg.steps):
        arr = torch.from_numpy(next(batches)).to(dev)
        params, opt_state, loss = step_fn(params, opt_state, arr[:, :-1],
                                          arr[:, 1:])
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            loss_f = float(loss)
            history.append({"step": step, "loss": loss_f,
                            "elapsed_s": time.time() - t0})
            if verbose:
                print(f"  train step {step:4d}  loss {loss_f:.4f}")
    for p in T.leaves(params):
        p.requires_grad_(False)
    return params, history
