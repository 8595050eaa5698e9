"""The STEP step scorer (paper §4.1, Appendix A).

A 2-layer MLP ``d_model -> 512 (ReLU) -> 1`` over last-layer hidden states
at reasoning-step boundaries. Training (``train_scorer``) waits for
ROADMAP A8; the port loads the JAX package's scorer weights through
``models.bridge`` or initializes its own from a seeded generator.
"""
from __future__ import annotations

import torch

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
