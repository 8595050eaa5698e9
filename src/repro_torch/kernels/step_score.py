"""Fused STEP scorer (2-layer MLP + sigmoid): the plain PyTorch version and
the wrapper of the hand-written CUDA kernel (``csrc/step_score.cu``).

The kernel replaces the TPU kernel
``src/repro/kernels/step_score.py::_scorer_kernel``. The engine fuses it
into every decode iteration of the kernel path: the [B, D] decode-batch
hiddens feed both matmuls without the [B, 512] activations going through
device memory.

The kernel runs in two launches: partial pre-activations over D-slices of
W1 spread across the card, then a fixed-order sum of the slices with the
ReLU, the W2 dot and the sigmoid (deterministic: no float atomics). On a
CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. Each call that launches adds one to
``LAUNCHES["step_score"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = {"step_score": 0}
_lib = None


def step_score_plain(hidden: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """hidden [B, D] -> scores [B] = sigmoid(relu(h @ w1 + b1) @ w2 + b2),
    all in f32."""
    z = torch.relu(hidden.float() @ w1 + b1)
    return torch.sigmoid((z @ w2 + b2)[..., 0])


def _library():
    global _lib
    if _lib is None:
        lib = build.load("step_score")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_step_score.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.repro_step_score.restype = i
        lib.repro_step_score_slice_rows.restype = i
        lib.slice_rows = lib.repro_step_score_slice_rows()
        _lib = lib
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"step_score kernel: {msg}")


def step_score(hidden: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """hidden [B, D] (bf16 or f32); w1 [D, Hd], b1 [Hd], w2 [Hd, 1],
    b2 [1] f32. Returns scores [B] f32 in [0, 1]."""
    if hidden.device.type == "cpu":
        return step_score_plain(hidden, w1, b1, w2, b2)
    B, D = hidden.shape
    Hd = w1.shape[1]
    for t in (hidden, w1, b1, w2, b2):
        _require(t.device == hidden.device, "operands on different devices")
        _require(t.is_contiguous(), "operands must be contiguous")
    for t in (w1, b1, w2, b2):
        _require(t.dtype == torch.float32, "scorer weights must be f32")
    _require(hidden.dtype in (torch.float32, torch.bfloat16),
             f"hidden dtype {hidden.dtype}")
    _require(w1.shape == (D, Hd) and b1.shape == (Hd,)
             and w2.shape == (Hd, 1) and b2.shape == (1,),
             "weights must be w1 [D, Hd], b1 [Hd], w2 [Hd, 1], b2 [1]")
    _require(Hd % 32 == 0 and 32 <= Hd <= 1024,
             f"hidden width {Hd} must be a multiple of 32 in [32, 1024]")
    _require(B >= 1 and D >= 1, f"hidden shape {tuple(hidden.shape)}")
    if w1.data_ptr() % 16:  # the kernel reads W1 as float4
        w1 = w1.clone()
    lib = _library()
    out = torch.empty((B,), dtype=torch.float32, device=hidden.device)
    # partial pre-activations, one row of them per slice of W1's rows
    part = torch.empty((-(-D // lib.slice_rows), B, Hd),
                       dtype=torch.float32, device=hidden.device)
    err = lib.repro_step_score(
        hidden.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), part.data_ptr(), B, D, Hd,
        int(hidden.dtype == torch.bfloat16),
        torch.cuda.current_stream(hidden.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"step_score kernel launch failed: CUDA error {err}")
    LAUNCHES["step_score"] += 1
    return out
