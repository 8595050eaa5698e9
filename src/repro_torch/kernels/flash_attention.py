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

The JAX package has no backward for this kernel (``jax.grad`` through it
fails) and trains with ``use_kernel=False``; the port keeps that: the
wrapper is a ``torch.autograd.Function`` whose backward raises.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises (no fallback), adding one to
``LAUNCHES["flash"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import masked_softmax_pv

LAUNCHES = {"flash": 0}
BLOCK = 128   # the TPU kernel's default q/kv block: S must tile by it
HEAD_DIMS = (32, 64, 80, 128)   # the head dims the kernel is built for
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
            [p] * 4 + [i] * 6 + [ctypes.c_float, p])
        lib.repro_flash_attention.restype = i
        _lib = lib
    return _lib


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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = _library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S,
        hd, int(q.dtype == torch.bfloat16), int(causal),
        -1 if window is None else int(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["flash"] += 1
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
