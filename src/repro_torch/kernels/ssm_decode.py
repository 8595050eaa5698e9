"""Mamba2's one-token decode state update: the plain PyTorch version and
the wrapper of the hand-written CUDA kernel (``csrc/ssm_decode.cu``).

The JAX package has no Pallas kernel for this step: inside its jitted
decode horizon XLA fuses ``causal_conv1d_step``, the SiLU, the step-size
decay, ``ssd_decode_step`` and the skip term of
``repro/models/layers.py::mamba2_mixer_decode``. The port's plain version
composes the same ops (the first two live here, and ``models/layers.py``
imports them); the kernel does their work in two launches that read and
write the [B, H, P, N] f32 state once, where the ops make about nine
passes over it.

The update is IN PLACE: ``conv_state`` [B, W-1, C] (bf16, the cache's
dtype whatever the params') and ``ssm_state`` [B, H, P, N] f32 take the
new states; the call returns y [B, H, P] f32 with the skip term added.
Every lane is updated, stopped ones included, as in the reference. On a
CPU tensor the wrapper runs the plain version and copies its states into
place; on a CUDA tensor it launches the kernel or raises, adding one to
``LAUNCHES["ssm_decode"]`` per call.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

LAUNCHES = {"ssm_decode": 0}
_lib = None


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor):
    """One-token SSD recurrence. state [B, H, P, N]; x [B, H, P];
    dt [B, H]; A [H]; Bm/Cm [B, N]. Returns (y [B, H, P], new_state)."""
    dA = torch.exp(dt * A[None, :])                       # [B, H]
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, x)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm)
    return y, new_state


def causal_conv1d_step(conv_state: torch.Tensor, x_t: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor):
    """conv_state [B, W-1, C]; x_t [B, C]. Returns (y [B, C], new_state
    [B, W-1, C]) in the promoted dtype of the state and the input."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # [B, W, C]
    y = torch.einsum("bwc,wc->bc", full, w.to(full.dtype)) + b[None, :]
    return y, full[:, 1:, :]


def ssm_decay(dt: torch.Tensor, dt_bias: torch.Tensor,
              A_log: torch.Tensor):
    """(softplus'd f32 step sizes, A = -exp(A_log) f32)."""
    return (F.softplus(dt.float() + dt_bias.float()),
            -torch.exp(A_log.float()))


def ssm_decode_plain(conv_state: torch.Tensor, ssm_state: torch.Tensor,
                     xbc: torch.Tensor, dt: torch.Tensor,
                     conv_w: torch.Tensor, conv_b: torch.Tensor,
                     dt_bias: torch.Tensor, A_log: torch.Tensor,
                     D: torch.Tensor):
    """xbc [B, di + 2N] and dt [B, H] from the input projection (the
    params' dtype); conv_w [W, di + 2N], conv_b; dt_bias, A_log, D [H].
    Returns (y [B, H, P] f32 with the skip term, new ssm_state f32, new
    conv_state in the promoted dtype): the composition of
    ``mamba2_mixer_decode``, without writing anything."""
    B, H, P, N = ssm_state.shape
    di = H * P
    conv, new_conv = causal_conv1d_step(conv_state, xbc, conv_w, conv_b)
    act = F.silu(conv.float()).to(xbc.dtype)
    xs = act[..., :di].reshape(B, H, P)
    Bm, Cm = act[..., di:di + N], act[..., di + N:]
    dt, A = ssm_decay(dt, dt_bias, A_log)
    y, new_state = ssd_decode_step(ssm_state, xs.float(), dt, A, Bm.float(),
                                   Cm.float())
    return y + xs.float() * D.float()[:, None], new_state, new_conv


def _library():
    global _lib
    if _lib is None:
        lib = build.load("ssm_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssm_decode.argtypes = ([p, p, p, i, p, i] + [p] * 7
                                         + [i] * 6 + [p])
        lib.repro_ssm_decode.restype = i
        _lib = lib
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssm_decode kernel: {msg}")


def ssm_decode(conv_state: torch.Tensor, ssm_state: torch.Tensor,
               xbc: torch.Tensor, dt: torch.Tensor, conv_w: torch.Tensor,
               conv_b: torch.Tensor, dt_bias: torch.Tensor,
               A_log: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """One decode step of one Mamba2 layer, the states updated in place
    (see the module docstring). Returns y [B, H, P] f32."""
    if conv_state.device.type == "cpu":
        y, new_state, new_conv = ssm_decode_plain(
            conv_state, ssm_state, xbc, dt, conv_w, conv_b, dt_bias, A_log,
            D)
        ssm_state.copy_(new_state)
        conv_state.copy_(new_conv)
        return y
    B, H, P, N = ssm_state.shape
    W, C = conv_w.shape
    dev = conv_state.device
    for t in (ssm_state, xbc, dt, conv_w, conv_b, dt_bias, A_log, D):
        _require(t.device == dev, "operands on different devices")
    _require(conv_state.dtype == torch.bfloat16
             and conv_state.shape == (B, W - 1, C)
             and conv_state.is_contiguous(),
             "conv_state must be [B, W-1, C] bf16, contiguous")
    _require(ssm_state.dtype == torch.float32 and ssm_state.is_contiguous(),
             "ssm_state must be [B, H, P, N] f32, contiguous")
    _require(C == H * P + 2 * N, f"{C} conv channels for H {H}, P {P}, N {N}")
    _require(xbc.dtype in (torch.bfloat16, torch.float32),
             f"xbc dtype {xbc.dtype}")
    for t in (dt, conv_w, conv_b):
        _require(t.dtype == xbc.dtype, "xbc, dt, conv_w and conv_b must "
                 "share a dtype")
    _require(xbc.shape == (B, C) and xbc.stride(1) == 1
             and dt.shape == (B, H) and dt.stride(1) == 1,
             "xbc must be [B, C] and dt [B, H], unit stride along a row")
    _require(conv_w.is_contiguous() and conv_b.shape == (C,)
             and conv_b.is_contiguous(), "conv_w [W, C], conv_b [C]")
    _require(2 <= W <= 8, f"conv width {W} not in [2, 8]")
    _require(N in (4, 8, 16, 32, 64, 128),
             f"state size {N} not a power of two in [4, 128]")
    dt_bias, A_log, D = (t.float().contiguous() for t in (dt_bias, A_log, D))
    for t in (dt_bias, A_log, D):
        _require(t.shape == (H,), "dt_bias, A_log and D must be [H]")
    act = torch.empty((B, C), dtype=torch.float32, device=dev)
    y = torch.empty((B, H, P), dtype=torch.float32, device=dev)
    err = _library().repro_ssm_decode(
        conv_state.data_ptr(), ssm_state.data_ptr(), xbc.data_ptr(),
        xbc.stride(0), dt.data_ptr(), dt.stride(0), conv_w.data_ptr(),
        conv_b.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
        D.data_ptr(), act.data_ptr(), y.data_ptr(), B, H, P, N, W,
        int(xbc.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_decode kernel launch failed: CUDA error {err}")
    LAUNCHES["ssm_decode"] += 1
    return y
