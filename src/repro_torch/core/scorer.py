"""The STEP step scorer (paper §4.1, Appendix A).

A 2-layer MLP ``d_model -> 512 (ReLU) -> 1`` over last-layer hidden states
at reasoning-step boundaries, trained with class-balanced weighted BCE
(alpha = K^- / K^+) on trace-level correctness pseudo-labels propagated to
every step (``train_scorer``; ``core.pipeline.build_step_scorer`` builds
its data). A scorer trained by the JAX package loads through
``models.bridge`` or ``training.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.training import tree as T
from repro_torch.training.optimizer import AdamW

SCORER_HIDDEN = 512  # paper Appendix A: Input -> 512 (ReLU) -> 1


def init_scorer(generator: torch.Generator, d_model: int,
                hidden: int = SCORER_HIDDEN) -> dict:
    """He-scaled random scorer on ``generator``'s device, f32."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    return {
        "w1": normal(d_model, hidden) * (2.0 / d_model) ** 0.5,
        "b1": torch.zeros((hidden,), dtype=torch.float32, device=dev),
        "w2": normal(hidden, 1) * (1.0 / hidden) ** 0.5,
        "b2": torch.zeros((1,), dtype=torch.float32, device=dev),
    }


def scorer_logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    """h [..., D] -> pre-sigmoid logits [...]."""
    z = torch.relu(h.float() @ params["w1"] + params["b1"])
    return (z @ params["w2"] + params["b2"])[..., 0]


def scorer_score(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Correctness probability in [0, 1]."""
    return torch.sigmoid(scorer_logits(params, h))


def weighted_bce_loss(params: dict, h: torch.Tensor, y: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Paper Eq. (loss): -(1/N) sum alpha*y*log p + (1-y)*log(1-p), in the
    numerically stable logits form."""
    logits = scorer_logits(params, h)
    yf = y.float()
    return -(alpha * yf * F.logsigmoid(logits)
             + (1 - yf) * F.logsigmoid(-logits)).mean()


@dataclasses.dataclass
class ScorerTrainConfig:
    """Paper Table 5 hyper-parameters."""
    batch_size: int = 128
    max_epochs: int = 20
    patience: int = 5
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    val_fraction: float = 0.1
    seed: int = 0


def train_scorer(hiddens: np.ndarray, labels: np.ndarray,
                 cfg: Optional[ScorerTrainConfig] = None,
                 params: Optional[dict] = None,
                 verbose: bool = False, device=None) -> Tuple[dict, dict]:
    """Train the step scorer. hiddens [M, D]; labels [M] in {0,1} (step
    pseudo-labels = trace correctness). The split and the batch orders
    come from ``numpy.random.RandomState(cfg.seed)``, as in the JAX
    package; the initial params from a generator seeded with ``cfg.seed``
    unless given (then copied: the caller's tensors are not updated).
    Runs on CUDA unless ``device`` names the CPU. Returns (params, info)
    with the params of the best validation epoch (early stopping)."""
    cfg = cfg or ScorerTrainConfig()
    dev = resolve_device(device)
    rng = np.random.RandomState(cfg.seed)
    M, D = hiddens.shape
    perm = rng.permutation(M)
    hiddens, labels = hiddens[perm], labels[perm]
    n_val = max(1, int(M * cfg.val_fraction))
    hv = torch.from_numpy(np.ascontiguousarray(hiddens[:n_val])).to(dev)
    yv = torch.from_numpy(np.ascontiguousarray(labels[:n_val])).to(dev)
    ht, yt = hiddens[n_val:], labels[n_val:]

    k_pos = max(int((yt == 1).sum()), 1)
    k_neg = max(int((yt == 0).sum()), 1)
    alpha = k_neg / k_pos  # paper: ratio of negative to positive samples

    if params is None:
        params = init_scorer(torch.Generator(device=dev).manual_seed(
            cfg.seed), D)
    else:
        params = T.map_tree(lambda x: x.detach().to(dev, torch.float32,
                                                    copy=True), params)
    opt = AdamW(learning_rate=cfg.learning_rate,
                weight_decay=cfg.weight_decay, grad_clip=None)
    opt_state = opt.init(params)
    leaves = T.leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    # the update runs in place: the best epoch's params are kept as copies
    best_val, bad_epochs = np.inf, 0
    best_params = T.map_tree(lambda x: x.detach().clone(), params)
    history = []
    n_train = len(ht)
    for epoch in range(cfg.max_epochs):
        order = rng.permutation(n_train)
        losses = []
        for i in range(0, n_train, cfg.batch_size):
            idx = order[i:i + cfg.batch_size]
            hb = torch.from_numpy(ht[idx]).to(dev)
            yb = torch.from_numpy(yt[idx]).to(dev)
            loss = weighted_bce_loss(params, hb, yb, alpha)
            grads = torch.autograd.grad(loss, leaves)
            params, opt_state = opt.update(T.unflatten(params, grads),
                                           opt_state, params)
            losses.append(float(loss.detach()))
        with torch.no_grad():
            vl = float(weighted_bce_loss(params, hv, yv, alpha))
        history.append({"epoch": epoch, "train_loss": float(np.mean(losses)),
                        "val_loss": vl})
        if verbose:
            print(f"scorer epoch {epoch}: train={np.mean(losses):.4f} "
                  f"val={vl:.4f}")
        if vl < best_val - 1e-5:
            best_val, bad_epochs = vl, 0
            best_params = T.map_tree(lambda x: x.detach().clone(), params)
        else:
            bad_epochs += 1
            if bad_epochs >= cfg.patience:  # early stopping (paper: 5)
                break
    info = {"alpha": alpha, "best_val_loss": best_val, "history": history}
    return best_params, info


def rank_accuracy(scores_pos: np.ndarray, scores_neg: np.ndarray) -> float:
    """Pairwise RankAcc (paper §5.3.2): P[s(p) > s(n)] over all pairs."""
    if len(scores_pos) == 0 or len(scores_neg) == 0:
        return float("nan")
    sp = scores_pos[:, None]
    sn = scores_neg[None, :]
    return float(np.mean((sp > sn) + 0.5 * (sp == sn)))
