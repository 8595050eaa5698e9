"""Mamba2 SSD chunked scan: the plain PyTorch version and the wrapper of
the hand-written CUDA kernel (``csrc/ssd_scan.cu``).

The kernel replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::
_ssd_kernel``: x [B, S, H, P], dt [B, S, H], A [H], Bm/Cm [B, S, N]
(ngroups = 1, shared by all heads), all f32; it returns y [B, S, H, P]
and the final state [B, H, P, N] of the recurrence

    h_t = h_{t-1} * exp(dt_t A) + dt_t x_t B_t^T,    y_t = h_t C_t,

computed chunk by chunk: the quadratic form inside a chunk, the carried
state across chunks. ``forward_full(..., use_kernel=True)`` reaches it
once per Mamba2 layer.

The JAX kernel has no backward (``jax.grad`` through it fails) and the
JAX package trains with ``use_kernel=False``; the port keeps that: the
wrapper is a ``torch.autograd.Function`` whose backward raises.

The kernel runs as five launches of the SSD decomposition (the in-chunk
cumsum, C.B^T per chunk, the chunk states, the state passing in chunk
order, the chunk outputs), each parallel over (batch row, chunk, head);
see ``csrc/ssd_scan.cu``. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises (no fallback),
adding one to ``LAUNCHES["ssd_scan"]`` per call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = {"ssd_scan": 0}
MAX_CHUNK = 256    # the cumsum pass stages one chunk of dt in shared memory
MAX_HEAD_DIM = 64  # P: one output tile's width of warp tiles
MAX_STATE = 128    # N: one chunk state's width of warp tiles
_lib = None


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   initial_state: Optional[torch.Tensor] = None):
    """The sequential recurrence of ``repro/kernels/ref.py::ssd_scan_ref``
    (the definitional oracle), one position at a time, in f32.
    Returns (y [B, S, H, P], final_state [B, H, P, N])."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32,
                          device=x.device))
    x, dt, A, Bm, Cm = x.float(), dt.float(), A.float(), Bm.float(), \
        Cm.float()
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])                 # [B, H]
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        h = h * decay[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def _library():
    global _lib
    if _lib is None:
        lib = build.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_scan.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.repro_ssd_scan.restype = i
        _lib = lib
    return _lib


def _launch(x, dt, A, Bm, Cm, chunk: int):
    """Check the operands and launch on the current stream."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for t in (x, dt, A, Bm, Cm):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("ssd_scan kernel: operands must be f32 on one "
                             "device")
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N) \
            or Cm.shape != (B, S, N):
        raise ValueError("ssd_scan kernel: shapes must be x [B,S,H,P], "
                         "dt [B,S,H], A [H], Bm/Cm [B,S,N]")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel: chunk {chunk} > {MAX_CHUNK}")
    if P > MAX_HEAD_DIM or 256 % P:
        raise ValueError(f"ssd_scan kernel: head dim {P} must divide 256 "
                         f"and be <= {MAX_HEAD_DIM}")
    if N > MAX_STATE or 256 % N:
        raise ValueError(f"ssd_scan kernel: state size {N} must divide 256 "
                         f"and be <= {MAX_STATE}")
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    cs = torch.empty((B, nc, H, chunk), **f32)  # in-chunk cumsum of dt*A
    # C.B^T of each chunk, once for all heads (lower triangle only)
    cb = torch.empty((B, nc, chunk, chunk), **f32)
    # each chunk's own state, then (in place) the state entering it
    st = torch.empty((B, nc, H, P, N), **f32)
    err = _library().repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), cs.data_ptr(),
        cb.data_ptr(), st.data_ptr(), B, S, H, P, N, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, h


class _SSDScan(torch.autograd.Function):
    """Forward only: the TPU kernel has no backward, so neither does the
    port's."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        if x.device.type == "cpu":
            return ssd_scan_plain(x, dt, A, Bm, Cm)
        return _launch(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        raise NotImplementedError(
            "ssd_scan has no backward (neither has the JAX package's "
            "_ssd_kernel): train with use_kernel=False")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             head_group: int = 4,
             initial_state: Optional[torch.Tensor] = None):
    """x [B, S, H, P]; dt [B, S, H]; A [H]; Bm/Cm [B, S, N] (ngroups = 1).
    Returns (y [B, S, H, P], final_state [B, H, P, N] f32).

    The reference's signature and restrictions: the scan starts from a
    zero state (``initial_state`` must be None; decode uses the one-step
    recurrence) and S must be a multiple of ``min(chunk, S)``.
    ``head_group`` is the TPU kernel's VMEM blocking of heads; the CUDA
    kernel runs its passes over (batch row, chunk, head) and computes
    C.B^T once per chunk for all heads, so it only checks that the group
    is positive."""
    if initial_state is not None:
        raise ValueError("ssd_scan starts from a zero state: "
                         "initial_state must be None")
    if head_group < 1:
        raise ValueError(f"head_group must be >= 1, got {head_group}")
    S = x.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssd_scan: sequence {S} not a multiple of the "
                         f"chunk {chunk}")
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
