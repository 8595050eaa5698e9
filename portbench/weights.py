"""The cell's weights, made on the device from ``--seed``: one
``torch.Generator`` on the card, one draw per stacked weight (per layer for
weights over 2**30 elements), drawn in the type they are served in.

The tree has the names and layouts the port's models read (stacked over a
leading layer axis). Scales: 1/sqrt(fan in), the output projections also
over sqrt(2 x layers), norms at one. The output head is shaped so that
the served text falls in the task's alphabet: the rows of the task's
tokens give logits of standard deviation ``head.task_logit_std`` at a
unit-RMS hidden state, every other row ``head.other_logit_std``, and the
end-of-sequence row is zero, so a trace runs to its token budget unless
it is pruned. The step scorer is the paper's MLP (D -> 512 -> 1) in f32.
"""
from __future__ import annotations

import math

import torch

from portbench import frozen

SCORER_HIDDEN = 512
MAX_DRAW = 2 ** 30


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def _draw(g: torch.Generator, shape, scale: float,
          dtype=torch.bfloat16) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=g.device)
    parts = [out] if out.numel() <= MAX_DRAW else list(out)
    for part in parts:
        part.normal_(0.0, 1.0, generator=g).mul_(scale)
    return out


def _head(g: torch.Generator, cfg: dict, rows_first: bool) -> torch.Tensor:
    """The output head [Vp, D] (rows_first, tied to the embedding) or
    [D, Vp], with the task's rows boosted and the EOS row zero."""
    D, Vp = cfg["d_model"], padded_vocab(cfg["vocab_size"])
    head = cfg["head"]
    w = _draw(g, (Vp, D), head["other_logit_std"] / math.sqrt(D))
    w[:frozen.TASK_VOCAB] *= head["task_logit_std"] / head["other_logit_std"]
    w[frozen.EOS_ID] = 0
    return w if rows_first else w.T.contiguous()


def make_params(cfg: dict, g: torch.Generator) -> dict:
    """Model weights of ``cfg`` (a configuration file's dict)."""
    L, D = cfg["num_layers"], cfg["d_model"]
    H, KVH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    depth = math.sqrt(2 * L)
    dev = g.device

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)

    attn = {"wq": _draw(g, (L, D, H * hd), 1 / math.sqrt(D)),
            "wk": _draw(g, (L, D, KVH * hd), 1 / math.sqrt(D)),
            "wv": _draw(g, (L, D, KVH * hd), 1 / math.sqrt(D)),
            "wo": _draw(g, (L, H * hd, D), 1 / math.sqrt(H * hd) / depth)}
    if cfg.get("qk_norm"):
        attn["q_norm"], attn["k_norm"] = ones(L, hd), ones(L, hd)
    layers = {"ln1": ones(L, D), "attn": attn, "ln2": ones(L, D)}
    if cfg.get("num_experts"):
        E, F = cfg["num_experts"], cfg["moe_d_ff"]
        layers["moe"] = {
            "router": _draw(g, (L, D, E), 1 / math.sqrt(D)),
            "experts": {"w_gate": _draw(g, (L, E, D, F), 1 / math.sqrt(D)),
                        "w_up": _draw(g, (L, E, D, F), 1 / math.sqrt(D)),
                        "w_down": _draw(g, (L, E, F, D),
                                        1 / math.sqrt(F) / depth)}}
    else:
        F = cfg["d_ff"]
        layers["mlp"] = {"w_gate": _draw(g, (L, D, F), 1 / math.sqrt(D)),
                         "w_up": _draw(g, (L, D, F), 1 / math.sqrt(D)),
                         "w_down": _draw(g, (L, F, D),
                                         1 / math.sqrt(F) / depth)}
    params = {"final_norm": ones(D), "layers": layers}
    if cfg.get("tie_embeddings"):
        params["embed"] = _head(g, cfg, rows_first=True)
    else:
        params["embed"] = _draw(g, (padded_vocab(cfg["vocab_size"]), D),
                                0.02)
        params["lm_head"] = _head(g, cfg, rows_first=False)
    return params


def make_scorer(d_model: int, g: torch.Generator) -> dict:
    """The step scorer's MLP, He-scaled, f32."""
    dev = g.device
    f32 = torch.float32
    return {"w1": _draw(g, (d_model, SCORER_HIDDEN),
                        math.sqrt(2.0 / d_model), f32),
            "b1": torch.zeros((SCORER_HIDDEN,), dtype=f32, device=dev),
            "w2": _draw(g, (SCORER_HIDDEN, 1), math.sqrt(1.0 / SCORER_HIDDEN),
                        f32),
            "b2": torch.zeros((1,), dtype=f32, device=dev)}


def make(cfg: dict, seed: int, device) -> tuple:
    """(params, scorer) of ``cfg`` from ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = make_params(cfg, g)
    return params, make_scorer(cfg["d_model"], g)
