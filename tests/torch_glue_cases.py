"""Shared cases of the decode-glue tests (``tests/test_torch_decode_glue.py``
on the CPU, ``tests/test_torch_cuda_glue.py`` on a card): one decode
layer's inputs at the cells' shapes, the chain of ops that the fused
attention prologue replaces, and bf16 ulp distances. No jax: the card
tests import it too."""
import torch

from repro_torch.kernels import decode_glue as G
from repro_torch.models import layers as L

BF16 = torch.bfloat16
EPS = 1e-6
# name -> (H, KVH, hd, D, qk_norm, rope theta): the cells' decode shapes
# and the zoo's other head dims (phi4-mini / internvl2 at 64, zamba2 at 80)
SHAPES = {
    "qwen3": (32, 8, 128, 2560, True, 1e6),
    "mixtral": (32, 8, 128, 4096, False, 1e6),
    "hd64": (16, 4, 64, 1024, True, 1e4),
    "hd80": (32, 32, 80, 2560, False, 1e4),
}
# the prologue's cases: all lanes live; every lane at position 0, where
# RoPE is the identity (cos 1, sin 0), so the qk-norm shows alone; lanes
# frozen on the scratch block; positions past the rolling window; the
# MoE's writer over shared slots
CASES = ("plain", "origin", "frozen", "wrap", "writer")


def bits_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps: the steps between the two bit patterns."""
    def key(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)   # order-preserving
    return (key(a) - key(b)).abs()


def within_one_ulp(got: torch.Tensor, want: torch.Tensor,
                   share: float = 0.01) -> float:
    """Assert no value of ``got`` lies more than one bf16 ulp from
    ``want`` and at most ``share`` of them one ulp; return that share."""
    apart = bits_apart(got, want)
    assert int(apart.max()) <= 1, f"{int(apart.max())} ulps apart"
    off = float((apart > 0).float().mean())
    assert off <= share, f"{off:.4%} of the values one ulp apart"
    return off


def rotated_within(got: torch.Tensor, want: torch.Tensor,
                   share: float = 0.01) -> float:
    """Assert each RoPE output of ``got`` [..., hd] lies within one bf16
    ulp of ``want``'s plus one ulp of each of the rotation's two inputs,
    which a one-ulp difference in the qk-norm before it carries through
    (the inputs' pair has the outputs' length, so ``want`` bounds them),
    and at most ``share`` of the values apart at all; return that share."""
    w = want.float()
    half = w.shape[-1] // 2
    r = torch.sqrt(w[..., :half] ** 2 + w[..., half:] ** 2)
    allowed = 2.0 ** -7 * (w.abs() + 2 * torch.cat([r, r], dim=-1))
    diff = (got.float() - w).abs()
    assert bool((diff <= allowed).all()), float((diff - allowed).max())
    off = float((diff > 0).float().mean())
    assert off <= share, f"{off:.4%} of the values apart"
    return off


def randn(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device=g.device)
            * scale).to(BF16)


def prologue_case(name: str, case: str, g: torch.Generator) -> dict:
    """One layer's decode inputs at ``name``'s shape over 64 lanes: the
    q/k/v products' outputs, the norms, positions, block tables over a
    shuffled pool of random K/V, and (case "writer") the MoE's writer.
    Lanes 16..23 point at the scratch block 0 in cases "frozen" and
    "writer"."""
    H, KVH, hd, _, qk_norm, theta = SHAPES[name]
    dev = g.device
    B, bs, window = 64, 16, 256
    bp = window // bs
    nb = B * bp + 1
    bt = torch.randperm(nb - 1, generator=g, device=dev)[:B * bp] + 1
    bt = bt.reshape(B, bp).to(torch.int32)
    pos = torch.randint(0, window, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    if case == "origin":
        pos.zero_()
    if case == "wrap":
        pos = pos + window * torch.randint(1, 3, (B,), generator=g,
                                           device=dev, dtype=torch.int32)
    if case in ("frozen", "writer"):
        bt[16:24] = 0
    return dict(
        q=randn(g, B, H * hd, scale=2), k=randn(g, B, KVH * hd, scale=2),
        v=randn(g, B, KVH * hd),
        q_norm=randn(g, hd, scale=0.1) + 1 if qk_norm else None,
        k_norm=randn(g, hd, scale=0.1) + 1 if qk_norm else None,
        positions=pos, block_tables=bt, window_len=window,
        pools=[randn(g, nb, bs, KVH, hd) for _ in range(2)],
        writer=(L.last_writer(bt, pos, window, bs) if case == "writer"
                else None),
        dims=(H, KVH, hd, theta))


def prologue_chain(c: dict, pools: list):
    """``gqa_attention_decode``'s ops between the products and the paged
    attention, writing ``pools`` in place. Returns (q [B, H, hd], the
    attended lengths)."""
    H, KVH, hd, theta = c["dims"]
    pos, window = c["positions"], c["window_len"]
    B = pos.shape[0]
    q = c["q"].reshape(B, H, hd)
    k = c["k"].reshape(B, KVH, hd)
    v = c["v"].reshape(B, KVH, hd)
    if c["q_norm"] is not None:
        q = L.rms_norm(q, c["q_norm"], EPS)
        k = L.rms_norm(k, c["k_norm"], EPS)
    cos, sin = L.rope_cos_sin(pos, hd, theta)
    cos, sin = cos[:, None, :], sin[:, None, :]
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    if c["writer"] is not None:
        k, v = k[c["writer"]], v[c["writer"]]
    slot = pos % window
    L.paged_kv_update_quant(pools[0], None, c["block_tables"], slot, k)
    L.paged_kv_update_quant(pools[1], None, c["block_tables"], slot, v)
    return q, torch.clamp(pos + 1, max=window).to(torch.int32)


def prologue_args(c: dict, pools: list, lens=None, table=None) -> tuple:
    """``attn_prologue``'s arguments for case ``c`` over ``pools``."""
    _, _, hd, theta = c["dims"]
    if table is None:
        table = G.rope_table(hd, theta, c["q"].device)
    return (c["q"], c["k"], c["v"], c["q_norm"], c["k_norm"], EPS,
            c["positions"], table, c["block_tables"], c["window_len"],
            pools[0], pools[1], c["writer"], lens)
