"""Token sampling (temperature / top-k / top-p) + confidence extraction.

Randomness comes from an explicit ``torch.Generator``: a sampled token is
``argmax(filtered_logits + gumbel)``, the form ``jax.random.categorical``
takes, with the Gumbel noise drawn from the generator. JAX's threefry and
torch's Philox never draw the same bits, so token identity with the JAX
package is a greedy contract (``temperature <= 0`` draws nothing); the
sampled path is held to it by passing both the same ``noise``. PyTorch
runs eagerly, so the host-side call sites (prefill first-token sampling,
the data pipeline) call these functions directly: ``sample_tokens``, the
JAX package's jitted wrapper, is ``sample_logits`` itself, and
``sample_tokens_lanes`` is ``sample_logits_lanes``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.8
    top_k: int = 20
    top_p: float = 0.95
    max_new_tokens: int = 160


def _gumbel(rng: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise shaped like ``like``: -log(E), E ~ Exp(1)."""
    e = torch.empty(like.shape, dtype=torch.float32, device=like.device)
    return -e.exponential_(generator=rng).log()


def _confidence(base_logp: torch.Tensor, tokens: torch.Tensor):
    return base_logp.gather(1, tokens[:, None]).exp()[:, 0]


def sample_logits(rng: Optional[torch.Generator], logits: torch.Tensor, *,
                  temperature: float = 0.8, top_k: int = 20,
                  top_p: float = 0.95,
                  noise: Optional[torch.Tensor] = None):
    """logits [B, V] -> (tokens [B] i32, confidence [B] f32).

    Confidence = probability the model assigned to the sampled token under
    the UNtempered distribution (the DeepConf-style signal).
    ``temperature <= 0`` is exact greedy: an argmax that draws nothing.
    ``noise`` [B, V] replaces the Gumbel draw from ``rng``."""
    logits_f = logits.float()
    base_logp = torch.log_softmax(logits_f, dim=-1)
    if temperature <= 0.0:
        tokens = logits_f.argmax(dim=-1)
        return tokens.to(torch.int32), _confidence(base_logp, tokens)

    V = logits.shape[-1]
    scaled = logits_f / max(temperature, 1e-6)
    if 0 < top_k < V:
        kth = scaled.sort(dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if 0.0 < top_p < 1.0:
        sorted_logits = scaled.sort(dim=-1).values.flip(-1)
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=V - 1)
        cutoff = sorted_logits.gather(1, cutoff_idx[:, None])
        scaled = torch.where(scaled < cutoff, -torch.inf, scaled)

    g = noise if noise is not None else _gumbel(rng, scaled)
    tokens = (scaled + g).argmax(dim=-1)
    return tokens.to(torch.int32), _confidence(base_logp, tokens)


sample_tokens = sample_logits


def sample_logits_lanes(rng: Optional[torch.Generator],
                        logits: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        noise: Optional[torch.Tensor] = None):
    """Lane-wise ``sample_logits``: per-row sampling params as [B]
    tensors (the per-request ``SamplingParams`` override path).

    The math mirrors the scalar path per lane. Greedy lanes
    (``temperature <= 0``) are an exact argmax; disabled filters
    (``top_k <= 0`` or ``>= V``, ``top_p`` outside (0, 1)) pass logits
    through unmasked."""
    B, V = logits.shape
    logits_f = logits.float()
    base_logp = torch.log_softmax(logits_f, dim=-1)
    temperature = temperature.float()[:, None]
    top_p = top_p.float()[:, None]
    scaled = logits_f / temperature.clamp(min=1e-6)

    # top-k: k-th largest value per lane from the ascending sort
    sorted_asc = scaled.sort(dim=-1).values
    k_idx = (V - top_k).clamp(0, V - 1).long()
    kth = sorted_asc.gather(1, k_idx[:, None])
    k_on = ((top_k > 0) & (top_k < V))[:, None]
    kth = torch.where(k_on, kth, -torch.inf)
    scaled = torch.where(scaled < kth, -torch.inf, scaled)

    # top-p: smallest prefix of the descending-sorted distribution with
    # cumulative mass >= top_p
    sorted_desc = sorted_asc.flip(-1)
    sorted_desc = torch.where(sorted_desc < kth, -torch.inf, sorted_desc)
    cum = torch.softmax(sorted_desc, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1).clamp(max=V - 1)
    cutoff = sorted_desc.gather(1, cutoff_idx[:, None])
    p_on = (top_p > 0.0) & (top_p < 1.0)
    cutoff = torch.where(p_on, cutoff, -torch.inf)
    scaled = torch.where(scaled < cutoff, -torch.inf, scaled)

    g = noise if noise is not None else _gumbel(rng, scaled)
    sampled = (scaled + g).argmax(dim=-1)
    greedy = logits_f.argmax(dim=-1)
    tokens = torch.where(temperature[:, 0] <= 0.0, greedy, sampled)
    return tokens.to(torch.int32), _confidence(base_logp, tokens)


sample_tokens_lanes = sample_logits_lanes
