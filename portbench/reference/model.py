"""The plain reference: the decoder stack of a configuration file, written
from the published description in plain PyTorch, in f32 with TF32 off.

It imports nothing of the program. It reads the benchmark's own weights
(``portbench/weights.py`` makes them and hands the same tensors to the
program), teacher-forces whole sequences (a prompt and the tokens the
program served after it) and works layer by layer over all of them, so
that only one layer's weights are held in f32 at a time.

  * attention: RMSNorm (``norm_eps``), GQA with ``num_kv_heads`` shared
    by ``num_heads / num_kv_heads`` query heads, per-head RMSNorm of q and
    k with ``qk_norm``, rotary embedding over the head (rotate-half, base
    ``rope_theta``), causal softmax at 1/sqrt(head_dim), within
    ``sliding_window`` when set;
  * feed-forward: SwiGLU; with ``num_experts`` the MoE: a softmax router,
    the top ``num_experts_per_tok`` experts (ties to the lower index),
    their weights renormalised to sum to one, each token's output the
    weighted sum of its experts' SwiGLUs (a row may be told to take the
    next expert in place of its last chosen one: a near tie resolved the
    other way, for ``compare.py``). The engine's capacity rule
    (each expert takes at most int(cf x tokens x k / E) of a group's
    pairs) drops nothing when cf x k / E >= 1, which
    :func:`check_config` requires: the reference routes every pair;
  * final RMSNorm, logits over ``vocab_size`` through the tied embedding
    or ``lm_head``;
  * the step scorer: sigmoid(relu(h W1 + b1) W2 + b2) on the final
    hidden state.

``fp8=True`` is the control: every product of the stack, the head and the
scorer takes both operands rounded to float8 e4m3 (weights per output
column, activations per row, each scaled to the format's largest value),
with f32 sums; the rest stays as above.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def check_config(cfg: dict) -> None:
    if cfg.get("num_experts"):
        cf = cfg["moe_capacity_factor"]
        if cf * cfg["num_experts_per_tok"] / cfg["num_experts"] < 1:
            raise ValueError(
                f"capacity factor {cf}: the engine would drop (token, "
                f"expert) pairs, which the reference does not model")


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled along ``dim`` to its range."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Weight:
    """One [in, out] weight in f32 (rounded to fp8 by output column for
    the control)."""

    def __init__(self, w: torch.Tensor, fp8: bool):
        self.fp8 = fp8
        self.w = w.float()
        if fp8:
            self.w = _q8(self.w, dim=-2)

    def __rmatmul__(self, x: torch.Tensor) -> torch.Tensor:
        return (_q8(x, dim=-1) if self.fp8 else x) @ self.w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] at positions 0..S-1, rotate-half."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: dict, p: dict, x: torch.Tensor, fp8: bool) -> torch.Tensor:
    S = x.shape[0]
    H, KVH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = (x @ p["wq"]).view(S, H, hd)
    k = (x @ p["wk"]).view(S, KVH, hd)
    v = (x @ p["wv"]).view(S, KVH, hd)
    if cfg.get("qk_norm"):
        q = rms_norm(q, p["q_norm"], cfg["norm_eps"])
        k = rms_norm(k, p["k_norm"], cfg["norm_eps"])
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = H // KVH
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    pos = torch.arange(S, device=x.device)
    mask = pos[None, :] <= pos[:, None]
    if cfg.get("sliding_window"):
        mask &= pos[None, :] > pos[:, None] - cfg["sliding_window"]
    s = s.masked_fill(~mask, float("-inf")).softmax(-1)
    return torch.einsum("hqk,khd->qhd", s, v).reshape(S, H * hd) @ p["wo"]


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    return (torch.nn.functional.silu(g) * (x @ p["w_up"])) @ p["w_down"]


def moe(cfg: dict, p: dict, x: torch.Tensor, fp8: bool,
        margins: Optional[list] = None,
        flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``flip``: rows that take the next expert in place of their last
    chosen one (a near tie resolved the other way)."""
    E, K = cfg["num_experts"], cfg["num_experts_per_tok"]
    logits = x @ p["router"]
    gates = logits.softmax(-1)
    vals, sel = torch.sort(gates, dim=-1, descending=True, stable=True)
    if margins is not None:   # router logit of the k-th choice over the next
        top = logits.sort(dim=-1, descending=True).values
        margins.append(top[:, K - 1] - top[:, K])
    if flip is not None and flip.numel():
        for t in (vals, sel):
            last, after = t[flip, K - 1].clone(), t[flip, K].clone()
            t[flip, K - 1], t[flip, K] = after, last
    w, sel = vals[:, :K], sel[:, :K]
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    out = torch.zeros_like(x)
    for e in range(E):
        rows, slot = (sel == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        ex = {n: Weight(t[e], fp8) for n, t in p["experts"].items()}
        out.index_add_(0, rows, w[rows, slot, None] * swiglu(ex, x[rows]))
    return out


def _layer(params: dict, l: int, fp8: bool) -> dict:
    src = params["layers"]
    a = src["attn"]
    out = {"ln1": src["ln1"][l], "ln2": src["ln2"][l],
           "attn": {n: (Weight(a[n][l], fp8) if n.startswith("w")
                        else a[n][l]) for n in a}}
    if "moe" in src:
        out["moe"] = {"router": Weight(src["moe"]["router"][l], fp8),
                      "experts": {n: t[l] for n, t in
                                  src["moe"]["experts"].items()}}
    else:
        out["mlp"] = {n: Weight(t[l], fp8) for n, t in src["mlp"].items()}
    return out


@torch.no_grad()
def hidden_states(cfg: dict, params: dict, seqs: Sequence[Sequence[int]],
                  fp8: bool = False, margins: Optional[list] = None,
                  layer_margins: Optional[list] = None,
                  flips: Optional[Dict[int, torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """The final (normed) hidden state [S, D] f32 of each sequence. With
    ``margins`` (a list; MoE), each sequence's per-token least margin over
    the layers between the router logits of a token's last chosen expert
    and the next one is appended to it; with ``layer_margins``, each
    sequence's margins [layers, S]. ``flips`` maps a layer to the rows
    (of the sequences laid end to end) that take the next expert there."""
    check_config(cfg)
    dev = params["final_norm"].device
    eps = cfg["norm_eps"]
    with exact_f32():
        hs = [params["embed"][torch.tensor(list(s), device=dev)].float()
              for s in seqs]
        sizes = [len(s) for s in seqs]
        per_layer = [] if margins is not None or layer_margins is not None \
            else None
        for l in range(cfg["num_layers"]):
            lp = _layer(params, l, fp8)
            hs = [h + attention(cfg, lp["attn"], rms_norm(h, lp["ln1"], eps),
                                fp8) for h in hs]
            h = torch.cat(hs)
            x = rms_norm(h, lp["ln2"], eps)
            h = h + (moe(cfg, lp["moe"], x, fp8, per_layer,
                         (flips or {}).get(l))
                     if "moe" in lp else swiglu(lp["mlp"], x))
            hs = list(h.split(sizes))
            del lp, h, x
        if per_layer:
            stacked = torch.stack(per_layer)
            if margins is not None:
                margins.extend(m.cpu() for m in
                               stacked.min(0).values.split(sizes))
            if layer_margins is not None:
                layer_margins.extend(m.cpu() for m in
                                     stacked.split(sizes, dim=1))
        return [rms_norm(h, params["final_norm"], eps) for h in hs]


def _head_weight(cfg: dict, params: dict) -> torch.Tensor:
    V = cfg["vocab_size"]
    if cfg.get("tie_embeddings"):
        return params["embed"][:V]          # [V, D]
    return params["lm_head"][:, :V].T       # [V, D]


@torch.no_grad()
def head_stats(cfg: dict, params: dict, h: torch.Tensor,
               targets: torch.Tensor, other: Optional[torch.Tensor] = None,
               block: int = 256) -> Dict[str, torch.Tensor]:
    """Per position of ``h`` [S, D]: the reference's logit of ``targets``
    [S] (``target``) and its log-normaliser (``lse``); with ``other`` (the
    control's hidden state), the control's log-probability of ``targets``
    (``other_target_logp``)."""
    W = _head_weight(cfg, params)
    out: Dict[str, list] = {k: [] for k in ("target", "lse",
                                              "other_target_logp")}
    with exact_f32():
        wf = W.float()
        wq = _q8(wf, dim=-1) if other is not None else None
        for i in range(0, h.shape[0], block):
            t = targets[i:i + block, None]
            lg = h[i:i + block] @ wf.T
            out["target"].append(lg.gather(1, t)[:, 0])
            out["lse"].append(lg.logsumexp(-1))
            if other is not None:
                lo = _q8(other[i:i + block], dim=-1) @ wq.T
                out["other_target_logp"].append(
                    lo.gather(1, t)[:, 0] - lo.logsumexp(-1))
    return {k: torch.cat(v).cpu() for k, v in out.items() if v}


@torch.no_grad()
def scores(scorer: dict, h: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Step scores [S] of hidden states [S, D]."""
    with exact_f32():
        z = torch.relu(h @ Weight(scorer["w1"], fp8) + scorer["b1"])
        return torch.sigmoid((z @ scorer["w2"] + scorer["b2"])[:, 0]).cpu()
