"""The decode layer's elementwise glue: the plain PyTorch versions and the
wrappers of the hand-written CUDA kernels (``csrc/decode_glue.cu``).

The JAX package has no Pallas kernel for this work: inside its jitted
decode horizon XLA fuses what lies between a layer's products. The port's
chain of PyTorch ops for it (``models/layers.py``: ``rms_norm``,
``rope_cos_sin`` and ``apply_rope``, the paged K/V write, the SwiGLU
gate) makes ~88 small launches a layer; three kernels do the same
arithmetic in four:

  add_rms_norm   (h + delta, rms_norm(h + delta, w)): the residual add and
                 the next norm (ln1, ln2, the final norm)
  attn_prologue  q and k normed over the head dim (qk-norm) and rotated
                 (RoPE); q returned, k and v written into each lane's pool
                 slot, the lanes' attended lengths written where asked
  silu_mul       SwiGLU's gate: silu(g) in f32 rounded to bf16, times u

Each ``*_plain`` function is its kernel's arithmetic in PyTorch, through
the chain's own ops: the same rounding points. The one RMSNorm,
:func:`rms_norm` (``models/layers.py`` imports it), takes torch's mean: on
a card the f32 sum of squares times 1/N, as the kernels take it (on the CPU
torch divides the sum by N). On a CPU tensor a wrapper runs its plain
version; on a CUDA tensor it launches the kernel or raises, adding one to
``LAUNCHES[<name>]`` per call. Which decode path takes them is
``models/layers.py::glue_route``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build

LAUNCHES = {"add_rms_norm": 0, "attn_prologue": 0, "silu_mul": 0}
HEAD_DIMS = (64, 80, 128)   # csrc/decode_glue.cu: hd / 2 <= 64 (MAX_PAIRS)
_lib = None
_tables: dict = {}


# ---------------------------------------------------------------------------
# RMSNorm, and RoPE's inverse frequencies and rotation (``models/layers.py``
# imports them)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., H, hd]; cos/sin broadcastable [..., 1, hd/2]."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def rope_inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    """[dim/2] f32: theta^(-2i/dim), by ``rope_cos_sin``'s own ops."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_table(dim: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_inv_freq`, made once per (dim, theta, device) and kept.
    Under a stream capture a table not yet made is made in the graph and
    not kept: a captured op writes its output only when the graph
    replays."""
    key = (dim, float(theta), str(torch.device(device)))
    table = _tables.get(key)
    if table is None:
        table = rope_inv_freq(dim, theta, device)
        if not (table.is_cuda and torch.cuda.is_current_stream_capturing()):
            _tables[key] = table
    return table


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def add_rms_norm_plain(h: torch.Tensor, delta: Optional[torch.Tensor],
                       w: torch.Tensor, eps: float):
    """(h' = h + delta, rms_norm(h', w)); h' is h where delta is None."""
    if delta is not None:
        h = h + delta
    return h, rms_norm(h, w, eps)


def attn_prologue_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_norm: Optional[torch.Tensor],
                        k_norm: Optional[torch.Tensor], eps: float,
                        positions: torch.Tensor, inv_freq: torch.Tensor,
                        block_tables: torch.Tensor, window_len: int,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        writer: Optional[torch.Tensor] = None,
                        lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """See :func:`attn_prologue`."""
    B = positions.shape[0]
    _, bs, KVH, hd = k_pool.shape
    q = q.reshape(B, -1, hd)
    k, v = k.reshape(B, KVH, hd), v.reshape(B, KVH, hd)
    if q_norm is not None:
        q, k = rms_norm(q, q_norm, eps), rms_norm(k, k_norm, eps)
    angles = positions.float()[:, None] * inv_freq
    cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    # each lane's slot, the rolling window wrapping it at window_len; under
    # a writer every lane sharing a slot stores its writer's K/V, the bytes
    # the kernel stores by the writer alone
    slot = (positions % window_len if window_len > 0 else positions).long()
    block = block_tables.long().gather(1, (slot // bs)[:, None])[:, 0]
    target = block * bs + slot % bs
    src = (torch.arange(B, device=positions.device) if writer is None
           else writer.long())
    k_pool.view(-1, KVH, hd)[target] = k[src].to(k_pool.dtype)
    v_pool.view(-1, KVH, hd)[target] = v[src].to(v_pool.dtype)
    if lens is not None:
        lens.copy_(torch.clamp(positions + 1, max=window_len)
                   if window_len > 0 else positions + 1)
    return q


def silu_mul_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) in f32, rounded to g's dtype, times u."""
    return F.silu(g.float()).to(g.dtype) * u


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        lib = build.load("decode_glue")
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.repro_add_rms_norm.argtypes = [p] * 5 + [i, i, f, f, p]
        lib.repro_add_rms_norm.restype = i
        lib.repro_attn_prologue.argtypes = (
            [p, ll, p, ll, p, ll, p, p, p, i, p, p, i, ll, i, p, i, p, p, p,
             i, i, p, i, i, i, i, i, f, f, p])
        lib.repro_attn_prologue.restype = i
        lib.repro_silu_mul.argtypes = [p, p, p, ll, p]
        lib.repro_silu_mul.restype = i
        _lib = lib
    return _lib


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what} kernel: {msg}")


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def add_rms_norm(h: torch.Tensor, delta: Optional[torch.Tensor],
                 w: torch.Tensor, eps: float):
    """h, delta [..., D] bf16 (delta None: the norm of h alone, as layer
    0's ln1); w [D] bf16. Returns (h' = h + delta rounded to bf16, or h
    itself, and rms_norm(h', w) bf16), both [..., D]."""
    if h.device.type == "cpu":
        return add_rms_norm_plain(h, delta, w, eps)
    what = "add_rms_norm"
    D = h.shape[-1]
    for t in (h, w) + (() if delta is None else (delta,)):
        _require(t.device == h.device and t.dtype == torch.bfloat16
                 and t.is_contiguous(), what,
                 "operands must be bf16, contiguous, on one device")
    _require(w.shape == (D,) and D % 8 == 0, what,
             f"w must be [D] with D a multiple of 8: D {D}")
    _require(delta is None or delta.shape == h.shape, what,
             "h and delta must have one shape")
    y = torch.empty_like(h)
    h_out = None if delta is None else torch.empty_like(h)
    err = _library().repro_add_rms_norm(
        h.data_ptr(), _ptr(delta), _ptr(h_out), w.data_ptr(), y.data_ptr(),
        h.numel() // D, D, 1.0 / D, eps, _stream(h))
    _launched(err, what)
    return (h if h_out is None else h_out), y


def attn_prologue(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_norm: Optional[torch.Tensor],
                  k_norm: Optional[torch.Tensor], eps: float,
                  positions: torch.Tensor, inv_freq: torch.Tensor,
                  block_tables: torch.Tensor, window_len: int,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  writer: Optional[torch.Tensor] = None,
                  lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A decode layer's attention prologue. q [B, H*hd], k, v [B, KVH*hd]:
    the products' outputs (bf16, unit stride along a row); q_norm, k_norm
    [hd] (both None: no qk-norm); positions [B] (int32/int64; each lane's
    new token); inv_freq [hd/2] f32 (:func:`rope_table`); block_tables
    [B, bp] (int32/int64); window_len: the cache capacity (0: none);
    k_pool, v_pool [N_blocks, bs, KVH, hd] bf16, written IN PLACE: each
    lane's normed, rotated K and its V go to its slot (slot = position,
    wrapped at ``window_len``, through its table row). ``writer`` [B]
    (``layers.last_writer``): only a lane that is its own writer writes,
    which stores what ``k[writer]`` written by every lane stores. ``lens``
    [B] int32, where given, takes the attended lengths (position + 1,
    capped at ``window_len``). Returns q normed and rotated, [B, H, hd]
    bf16. A slot past its table row, or a table entry past the pool,
    faults the kernel (the CUDA context is lost, as after the chain's
    out-of-range gather); the plain version raises."""
    if q.device.type == "cpu":
        return attn_prologue_plain(q, k, v, q_norm, k_norm, eps, positions,
                                   inv_freq, block_tables, window_len,
                                   k_pool, v_pool, writer, lens)
    what = "attn_prologue"
    B = positions.shape[0]
    N, bs, KVH, hd = k_pool.shape
    H = q.shape[-1] // hd
    dev = q.device
    for t in (q, k, v):
        _require(t.dtype == torch.bfloat16 and t.device == dev
                 and t.dim() == 2 and t.shape[0] == B and t.stride(1) == 1,
                 what, "q, k and v must be [B, heads*hd] bf16 rows")
    _require(hd in HEAD_DIMS and q.shape[1] == H * hd
             and k.shape[1] == KVH * hd and v.shape[1] == KVH * hd, what,
             f"head dim {hd} not in {HEAD_DIMS}, or q/k/v widths")
    for pool in (k_pool, v_pool):
        _require(pool.dtype == torch.bfloat16 and pool.device == dev
                 and pool.shape == (N, bs, KVH, hd) and pool.is_contiguous(),
                 what, "pools must be [N_blocks, bs, KVH, hd] bf16, "
                 "contiguous")
    _require((q_norm is None) == (k_norm is None), what,
             "q_norm and k_norm go together")
    for t in (q_norm, k_norm):
        _require(t is None or (t.dtype == torch.bfloat16 and t.shape == (hd,)
                               and t.is_contiguous()), what,
                 "q_norm/k_norm must be [hd] bf16")
    _require(inv_freq.dtype == torch.float32 and inv_freq.shape == (hd // 2,)
             and inv_freq.is_contiguous(), what, "inv_freq must be [hd/2] f32")
    index = (torch.int32, torch.int64)
    for t in (positions, block_tables) + (() if writer is None
                                          else (writer,)):
        _require(t.dtype in index and t.device == dev
                 and t.stride(-1) == 1, what,
                 "positions, block tables and writer must be int32/int64")
    _require(block_tables.dim() == 2 and block_tables.shape[0] == B
             and positions.is_contiguous()
             and (writer is None or (writer.shape == (B,)
                                     and writer.is_contiguous())), what,
             "positions [B], block_tables [B, bp], writer [B]")
    _require(lens is None or (lens.dtype == torch.int32 and lens.shape == (B,)
                              and lens.is_contiguous()), what,
             "lens must be [B] int32")
    q_out = torch.empty((B, H, hd), dtype=torch.bfloat16, device=dev)
    err = _library().repro_attn_prologue(
        q.data_ptr(), q.stride(0), k.data_ptr(), k.stride(0), v.data_ptr(),
        v.stride(0), _ptr(q_norm), _ptr(k_norm), positions.data_ptr(),
        int(positions.dtype == torch.int64), inv_freq.data_ptr(),
        block_tables.data_ptr(), int(block_tables.dtype == torch.int64),
        block_tables.stride(0), block_tables.shape[1], _ptr(writer),
        int(writer is not None and writer.dtype == torch.int64),
        q_out.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), N, bs,
        _ptr(lens), B, H, KVH, hd, window_len, 1.0 / hd, eps, _stream(q))
    _launched(err, what)
    return q_out


def silu_mul_fits(g: torch.Tensor, u: torch.Tensor) -> bool:
    """Whether :func:`silu_mul`'s kernel takes (g, u): plain bf16 CUDA
    tensors of one shape, contiguous and 16-byte aligned, with no
    gradient to carry (the kernel has no backward)."""
    return (g.is_cuda and not isinstance(g, DTensor)
            and not isinstance(u, DTensor)
            and g.dtype == torch.bfloat16 and u.dtype == torch.bfloat16
            and g.device == u.device and g.shape == u.shape
            and g.is_contiguous() and u.is_contiguous()
            and g.data_ptr() % 16 == 0 and u.data_ptr() % 16 == 0
            and not (torch.is_grad_enabled()
                     and (g.requires_grad or u.requires_grad)))


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u for g, u of one shape (bf16 on a card; see
    :func:`silu_mul_fits`): silu in f32, rounded to bf16, times u."""
    if g.device.type == "cpu":
        return silu_mul_plain(g, u)
    _require(silu_mul_fits(g, u), "silu_mul",
             "g and u must be bf16 CUDA tensors of one shape, contiguous, "
             "16-byte aligned, with no gradient")
    out = torch.empty_like(g)
    err = _library().repro_silu_mul(g.data_ptr(), u.data_ptr(),
                                    out.data_ptr(), g.numel(), _stream(g))
    _launched(err, "silu_mul")
    return out
