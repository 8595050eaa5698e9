"""Blockwise (flash) attention forward: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel (``csrc/flash_attention.cu``).

The kernel replaces the TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``: q, k, v
``[B, H, S, hd]`` with the kv heads already broadcast, an optional causal
mask and sliding ``window``, f32 scores, softmax and P.V, the output in
q's dtype. A row with no visible key emits zeros. ``forward_full(...,
use_kernel=True)`` reaches it once per layer. In bf16 the kernel runs on
the tensor cores and rounds P to bf16 before P.V, as ``mha_ref`` does
(``paged_attention.tiled_softmax_pv`` with ``p_dtype=torch.bfloat16`` is
that algebra); in f32 it computes in f32 throughout.

The kernel has three faces, chosen from head dim and dtype alone
(:func:`flash_face`): bf16 at hd 64, 80 and 128 on ``wgmma`` with TMA
loads (64 or 128 query rows per CTA, :func:`flash_rows`, visiting the key
tiles of :func:`flash_plan`), bf16 at hd 32 on the ``mma.sync`` tile, and
f32 on the tensor cores in 3xTF32.

The JAX package has no backward for this kernel (``jax.grad`` through it
fails) and trains with ``use_kernel=False``; the port keeps that: the
wrapper is a ``torch.autograd.Function`` whose backward raises.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises (no fallback), adding one to
``LAUNCHES["flash"]`` (every face) and one to its face's
``LAUNCHES["flash_wgmma"]``, ``["flash_tile"]`` or ``["flash_f32_tc"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import masked_softmax_pv

LAUNCHES = {"flash": 0, "flash_wgmma": 0, "flash_tile": 0,
            "flash_f32_tc": 0}
BLOCK = 128   # the TPU kernel's default q/kv block: S must tile by it
HEAD_DIMS = (32, 64, 80, 128)   # the head dims the kernel is built for
WGMMA_HEAD_DIMS = (64, 80, 128)   # bf16 rows the wgmma face takes
SMS = 132       # the H100 SXM's streaming multiprocessors
_lib = None


def attention_mask(S: int, causal: bool, window: Optional[int],
                   device) -> torch.Tensor:
    """[S, S] boolean mask of the visible (query, key) pairs."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    return mask


def flash_face(hd: int, dtype: torch.dtype) -> str:
    """The kernel face for head dim ``hd`` and ``dtype``: "wgmma" (bf16
    at hd 64, 80, 128: TMA loads, warpgroup products), "tile" (bf16 at
    hd 32, whose 64-byte rows are half of wgmma's 128-byte swizzle atom:
    the mma.sync tile) or "f32_tc" (f32: the tensor cores in 3xTF32)."""
    if dtype == torch.float32:
        return "f32_tc"
    return "wgmma" if hd in WGMMA_HEAD_DIMS else "tile"


def flash_rows(BH: int, S: int, hd: int, dtype: torch.dtype) -> int:
    """Query rows per CTA of the wgmma face for ``BH`` (batch x heads)
    sequences of ``S`` tokens, or 0 where another face takes the call. 128
    rows (two consumer warpgroups, each K/V tile read serving both) unless
    ``BH * ceil(S / 128)`` CTAs would leave SMs idle: then 64, twice the
    CTAs (seamless's decoder, B*H 16 at S 512, makes 64 CTAs of 128 rows
    for 132 SMs)."""
    if flash_face(hd, dtype) != "wgmma":
        return 0
    return 64 if BH * -(-S // 128) < SMS else 128


def _span(S: int, r0: int, r1: int, causal: bool, window: Optional[int],
          key_tile: int):
    """The kernel's ``Tiles`` over query rows r0..r1: the key tiles (of
    ``key_tile`` keys) holding a key that some live row (< S) sees, and
    the test ``masked(t)``: true unless every key of tile t is visible to
    every live row."""
    r1 = min(r1, S - 1)

    def lo(q):
        return 0 if window is None else max(0, q - window + 1)

    def hi(q):
        return min(q, S - 1) if causal else S - 1

    lo_last, hi_first = (lo(r1), hi(r0)) if r0 <= r1 else (0, -1)

    def masked(t):
        return not (t * key_tile >= lo_last
                    and t * key_tile + key_tile - 1 <= hi_first)

    a, b = r0, r1
    if window is not None:
        if causal and window == 0:
            b = -1
        elif not causal:
            b = min(b, S + window - 2)   # rows past it see nothing
    tiles = (range(lo(a) // key_tile, hi(b) // key_tile + 1) if a <= b
             else range(0))
    return tiles, masked


def flash_plan(S: int, rows: int, causal: bool,
               window: Optional[int] = None,
               key_tile: Optional[int] = None) -> list:
    """The schedule of one (batch, head), the host's copy of the kernel's
    ``Tiles``: CTAs of ``rows`` query rows over key tiles of ``key_tile``
    keys (the wgmma face: as many as ``rows``; the tile and f32 faces: 64,
    in CTAs of 128 rows). One dict per CTA: ``rows`` (its first row and one
    past its last live one), ``tiles`` (the key tiles it loads and
    computes, ``(tile, masked)``) and ``groups`` (for each 64-row consumer
    warpgroup, the same tiles with the warpgroup's own ``masked``: a tile
    none of its rows sees is computed masked, p = 0). A tile is visited iff
    some live row of the CTA sees one of its keys, and ``masked`` unless
    every key of it is visible to every live row: the causal diagonal, the
    window's left edge, the end of a ragged S."""
    key_tile = key_tile or rows
    plan = []
    for q0 in range(0, S, rows):
        tiles, masked = _span(S, q0, q0 + rows - 1, causal, window,
                              key_tile)
        groups = [_span(S, g0, g0 + 63, causal, window, key_tile)[1]
                  for g0 in range(q0, q0 + rows, 64)]
        plan.append({"rows": (q0, min(S, q0 + rows)),
                     "tiles": [(t, masked(t)) for t in tiles],
                     "groups": [[(t, g(t)) for t in tiles] for g in groups]})
    return plan


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The function of ``repro/kernels/ref.py::mha_ref`` with the kernel's
    numerics: f32 scores, softmax and P.V (the reference rounds P to the
    value dtype first), and zeros for a row with no visible key.
    q/k/v [B, H, S, hd]; returns [B, H, S, hd] in q's dtype."""
    S, hd = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(S, causal, window, q.device)
    out = masked_softmax_pv(scores, mask[None, None], v, "bhqk,bhkd->bhqd")
    return out.to(q.dtype)


def _library():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = (
            [p] * 4 + [i] * 6 + [ctypes.c_float, i, p])
        lib.repro_flash_attention.restype = i
        _lib = lib
    return _lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the wgmma face's tensor maps."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal: bool, window: Optional[int],
            scale: float) -> torch.Tensor:
    """Check the operands and launch on the current stream."""
    B, H, S, hd = q.shape
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v must share "
                             "shape, dtype and device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention kernel: dtype {q.dtype}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    face = flash_face(hd, q.dtype)
    err = _library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S,
        hd, int(q.dtype == torch.bfloat16), int(causal),
        -1 if window is None else int(window), scale,
        flash_rows(B * H, S, hd, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({face} face) launch "
                           f"failed: CUDA error {err}")
    LAUNCHES["flash"] += 1
    LAUNCHES["flash_" + face] += 1
    return out


class _FlashForward(torch.autograd.Function):
    """Forward only: the TPU kernel has no backward, so neither does the
    port's."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal, window, scale)
        return _launch(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention has no backward (neither has the JAX "
            "package's _flash_kernel): train with use_kernel=False")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v [B, H, S, hd] (kv heads pre-broadcast). Returns [B, H, S, hd]
    in q's dtype. S must be a multiple of ``min(128, S)``, the TPU
    kernel's block, as its assert requires."""
    S, hd = q.shape[2], q.shape[3]
    blk = min(BLOCK, S)
    if S % blk:
        raise ValueError(f"flash_attention: sequence {S} not a multiple of "
                         f"the block {blk}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    return _FlashForward.apply(q, k, v, causal, window, scale)
