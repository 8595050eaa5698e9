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

The kernel has two faces, chosen from shapes alone (:func:`ssd_face`).
At the zoo's full width (P = 64, N = 64 or 128, a chunk of 64, 128, 192
or 256) the "wgmma" face, ``csrc/ssd_wgmma.cu``: three launches (the
chunk states with the in-chunk cumsum, the state passing in chunk order,
the chunk outputs with C.B^T computed once per head group), every
product on ``wgmma`` in 3xTF32, operands brought by TMA; the grid and
head group of its last launch are :func:`ssd_plan`'s, and
:func:`ssd_wgmma_plain` is its algebra in PyTorch. Every other shape (the
JAX tests' small P and N, odd chunks) runs the "tile" face,
``csrc/ssd_scan.cu``: five launches (cumsum, C.B^T per chunk, the chunk
states, the state passing, the chunk outputs) on ``mma.sync``.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the face's kernel or raises (no fallback), adding one to
``LAUNCHES["ssd_scan"]`` (every face) and one to its face's
``LAUNCHES["ssd_scan_wgmma"]`` or ``["ssd_scan_tile"]``.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = {"ssd_scan": 0, "ssd_scan_wgmma": 0, "ssd_scan_tile": 0}
MAX_CHUNK = 256    # the cumsum pass stages one chunk of dt in shared memory
MAX_HEAD_DIM = 64  # P: one output tile's width of warp tiles
MAX_STATE = 128    # N: one chunk state's width of warp tiles
TILE = 64          # the wgmma face's rows per tile and positions per block
WGMMA_STATES = (64, 128)   # N the wgmma face is built for (P = 64)
SMS = 132          # the H100 SXM's streaming multiprocessors
_libs = {}


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


# ---------------------------------------------------------------------------
# the wgmma face (csrc/ssd_wgmma.cu): its route, its launch plan from
# shapes on the host, and its algebra in PyTorch
# ---------------------------------------------------------------------------

def ssd_face(P: int, N: int, chunk: int) -> str:
    """The face for head dim ``P``, state ``N`` and the chunk the call
    runs (``min(chunk, S)``), from shapes alone: "wgmma" at P = 64,
    N = 64 or 128 and a chunk that is a multiple of 64 up to 256 (whole
    64-row tiles, 64-position blocks, one chunk of dt staged per head);
    "tile" (``csrc/ssd_scan.cu``) for every other shape."""
    if (P == 64 and N in WGMMA_STATES and chunk % TILE == 0
            and TILE <= chunk <= MAX_CHUNK):
        return "wgmma"
    return "tile"


def ssd_items(B: int, S: int, H: int, chunk: int, G: int,
              tile: int = TILE) -> list:
    """The CTAs of the wgmma face's output launch, in launch order:
    (b, chunk, head group, tile) with the tiles of the most key blocks
    first (a tile t runs t + 1 blocks of the intra product), then batch
    row, chunk and head group. Group k holds heads k*G .. k*G + G - 1 (the
    last group may hold fewer); its two warpgroups take its heads in turn
    (group heads 0, 2, ... and 1, 3, ...). ``tile``: rows per tile (the
    kernel's 64; the CPU emulation also runs smaller chunks)."""
    nc, HG, NT = S // chunk, -(-H // G), chunk // tile
    return [(b, c, hg, t) for t in reversed(range(NT)) for b in range(B)
            for c in range(nc) for hg in range(HG)]


def _item_cost(c: int, t: int, heads: int, halves: int) -> int:
    """An output CTA's time in products of 64 x 64 x 8 (three tf32
    products each): its share of C.B^T (t + 1 blocks over N, the
    warpgroups taking alternate blocks), and per head the carry-in (not
    for chunk 0) and t + 1 intra blocks, the warpgroups' heads run side
    by side on one SM's tensor cores (twice the busier one's), plus a
    fixed cost of the tile's loads."""
    per_head = 24 * ((halves if c else 0) + t + 1)
    busier = -(-heads // 2) * per_head
    return 48 + 24 * halves * (t + 1) + 2 * busier


@functools.lru_cache(maxsize=256)
def ssd_plan(B: int, S: int, H: int, N: int, chunk: int,
             sms: int = SMS) -> dict:
    """The head group G of the wgmma face's output launch, from shapes and
    the SM count alone: of the divisors of H up to 32 (a divisor leaves
    no group short), the one whose CTAs (:func:`ssd_items`, one per SM at
    a time, dispatched in order to the first SM free) finish first by
    :func:`_item_cost`; ties go to the larger group (C.B^T is computed
    once per group). Returns {"G", "items", "makespan"}."""
    halves = N // 64
    best = None
    for G in [d for d in range(1, min(H, 32) + 1) if H % d == 0]:
        free = [0] * min(sms, 1 << 30)
        heapq.heapify(free)
        items = ssd_items(B, S, H, chunk, G)
        for b, c, hg, t in items:
            heads = min(G, H - hg * G)
            start = heapq.heappop(free)
            heapq.heappush(free, start + _item_cost(c, t, heads, halves))
        span = max(free)
        if best is None or span <= best["makespan"]:
            best = {"G": G, "items": len(items), "makespan": span}
    return best


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits cleared."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(v: torch.Tensor):
    """(big, small): big = tf32(v), small = tf32(v - big)."""
    big = tf32_round(v)
    return big, tf32_round(v - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's tensor cores take it in 3xTF32: each operand
    split in big and small halves, a_small b_big + a_big b_small +
    a_big b_big summed in f32, small terms first."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _cumsum_in_order(dA: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis, one f32 addition at a time in
    order (one thread per head in the kernel): equal prefixes round alike,
    so a padded step (dt = 0) keeps cs, and its decay is exactly 1."""
    out = torch.empty_like(dA)
    s = torch.zeros_like(dA[..., 0])
    for j in range(dA.shape[-1]):
        s = s + dA[..., j]
        out[..., j] = s
    return out


def ssd_wgmma_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    G: Optional[int] = None, *, tf32: bool = True):
    """The wgmma face's algebra in PyTorch, launch by launch, in f32.

    1. per (b, chunk, head): cs in order; w_j = dt_j exp(cs_last - cs_j)
       folded into the A operand (x^T, scaled per position); the chunk
       state s[p, n] = (x w)^T B.
    2. the state passing in chunk order: h_in[0] = 0,
       h_in[c + 1] = exp(cs_last[c]) h_in[c] + s[c]; the last is the final
       state.
    3. per output CTA of :func:`ssd_items` (b, chunk, head group of G,
       64-row tile t): C.B^T of the tile's rows against key blocks
       0 .. t, once for the group; per head the carry-in C h_in^T with
       its rows scaled by exp(cs_i) (skipped for chunk 0), then L =
       C.B^T exp(cs_i - cs_j) dt_j formed only where j <= i (left of the
       diagonal block the decay as exp(cs_i - cs_i0) exp(cs_i0 - cs_j),
       i0 the tile's first row), y += L x.

    ``tf32``: every product in 3xTF32 (:func:`mm_3xtf32`), as the tensor
    cores take it; False keeps them in f32. Tiles are the kernel's 64 rows,
    or the whole chunk where it is shorter (the JAX tests' chunks of 16
    and 32). Returns (y, final_state)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if G is None:
        G = ssd_plan(B, S, H, N, chunk)["G"]
    tile = min(TILE, chunk)
    if chunk % tile:
        raise ValueError(f"chunk {chunk} is not whole tiles of {tile}")
    mm = mm_3xtf32 if tf32 else torch.matmul
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    nc, l = S // chunk, chunk
    xc = x.reshape(B, nc, l, H, P)
    dtc = dt.reshape(B, nc, l, H).movedim(-1, 2)           # [B, nc, H, l]
    Bc, Cc = Bm.reshape(B, nc, l, N), Cm.reshape(B, nc, l, N)
    cs = _cumsum_in_order(dtc * A[None, None, :, None])   # [B, nc, H, l]
    # 1. chunk states: (x w)^T [P, l] @ B [l, N], per head
    w = dtc * torch.exp2((cs[..., -1:] - cs) * math.log2(math.e))
    xw = xc.movedim(2, -1) * w[:, :, :, None, :]          # [B, nc, H, P, l]
    st = mm(xw, Bc[:, :, None])                            # [B, nc, H, P, N]
    # 2. state passing, in chunk order
    h_in = torch.zeros_like(st)
    run = torch.zeros_like(st[:, 0])
    for c in range(nc):
        h_in[:, c] = run
        run = torch.exp(cs[:, c, :, -1])[..., None, None] * run + st[:, c]
    # 3. outputs, CTA by CTA
    y = torch.zeros_like(xc)
    log2e = math.log2(math.e)
    for b, c, hg, t in ssd_items(B, S, H, chunk, G, tile):
        heads = slice(hg * G, min(H, hg * G + G))
        rows = slice(t * tile, (t + 1) * tile)
        keys = slice(0, (t + 1) * tile)
        cb = mm(Cc[b, c, rows], Bc[b, c, keys].T)           # [64, keys]
        csh = cs[b, c, heads]                                 # [g, l]
        ci = csh[:, rows, None]                               # [g, 64, 1]
        acc = torch.zeros(csh.shape[0], tile, P)
        if c > 0:
            acc = (mm(Cc[b, c, rows][None],
                      h_in[b, c, heads].transpose(-1, -2)) * torch.exp(ci))
        i = torch.arange(t * tile, (t + 1) * tile)[:, None]
        j = torch.arange(0, (t + 1) * tile)[None, :]
        below = (j <= i)[None]
        # the diagonal block: exp(cs_i - cs_j), only where j <= i; left of
        # it exp(cs_i - cs_i0) exp(cs_i0 - cs_j), i0 the tile's first row
        diag = torch.exp2(torch.where(
            below, (ci - csh[:, None, keys]) * log2e, -torch.inf))
        ref = csh[:, t * tile, None, None]
        left = (torch.exp2((ci - ref) * log2e)
                * torch.exp2((ref - csh[:, None, keys]) * log2e))
        decay = torch.where(j < t * tile, left, diag)
        L = cb[None] * decay * dtc[b, c, heads, None, keys]
        L = torch.where(below, L, 0.0)
        acc = acc + mm(L, xc[b, c, keys][:, heads].movedim(1, 0))
        y[b, c, rows][:, heads] = acc.movedim(0, 1)
    return y.reshape(B, S, H, P), run


def _library(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "ssd_scan":
            lib.repro_ssd_scan.argtypes = [p] * 10 + [i] * 6 + [p]
            lib.repro_ssd_scan.restype = i
        else:
            lib.repro_ssd_wgmma.argtypes = [p] * 9 + [i] * 6 + [p]
            lib.repro_ssd_wgmma.restype = i
        _libs[name] = lib
    return lib


def _check(x, dt, A, Bm, Cm, chunk: int):
    """Check the operands of either face; returns them contiguous."""
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
    return tuple(t.contiguous() for t in (x, dt, A, Bm, Cm))


def _scratch(x, N: int, chunk: int):
    B, S, H, P = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), **f32)
    cs = torch.empty((B, S // chunk, H, chunk), **f32)  # in-chunk cumsum
    # each chunk's own state, then (in place) the state entering it
    st = torch.empty((B, S // chunk, H, P, N), **f32)
    return y, h, cs, st


def _launch_tile(x, dt, A, Bm, Cm, chunk: int):
    """Check the operands and launch the tile face (``csrc/ssd_scan.cu``)
    on the current stream."""
    x, dt, A, Bm, Cm = _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    y, h, cs, st = _scratch(x, N, chunk)
    # C.B^T of each chunk, once for all heads (lower triangle only)
    cb = torch.empty((B, S // chunk, chunk, chunk), dtype=torch.float32,
                     device=x.device)
    err = _library("ssd_scan").repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), cs.data_ptr(),
        cb.data_ptr(), st.data_ptr(), B, S, H, P, N, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan_tile"] += 1
    return y, h


def _launch_wgmma(x, dt, A, Bm, Cm, chunk: int):
    """Check the operands and launch the wgmma face
    (``csrc/ssd_wgmma.cu``) on the current stream, at :func:`ssd_plan`'s
    head group for this card's SM count."""
    x, dt, A, Bm, Cm = _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if ssd_face(P, N, chunk) != "wgmma":
        raise ValueError(f"ssd_scan wgmma face: P {P}, N {N}, chunk {chunk} "
                         f"is the tile face's shape")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    G = ssd_plan(B, S, H, N, chunk, sms)["G"]
    y, h, cs, st = _scratch(x, N, chunk)
    err = _library("ssd_wgmma").repro_ssd_wgmma(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h.data_ptr(), cs.data_ptr(),
        st.data_ptr(), B, S, H, N, chunk, G,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan wgmma launch failed: CUDA error {err}")
    LAUNCHES["ssd_scan_wgmma"] += 1
    return y, h


def _launch(x, dt, A, Bm, Cm, chunk: int):
    """The face :func:`ssd_face` picks, on the current stream."""
    face = ssd_face(x.shape[-1], Bm.shape[-1], chunk)
    out = (_launch_wgmma if face == "wgmma" else _launch_tile)(
        x, dt, A, Bm, Cm, chunk)
    LAUNCHES["ssd_scan"] += 1
    return out


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
    faces group heads their own way (the wgmma face by :func:`ssd_plan`,
    from shapes and the SM count; the tile face computes C.B^T once per
    chunk for all heads), so it only checks that the group is
    positive."""
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


def ssd_scan_tile(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128):
    """The tile face (``csrc/ssd_scan.cu``) for any shape the wrapper
    takes, whatever :func:`ssd_face` picks: called directly, it times the
    two faces on one input. Counts under ``LAUNCHES["ssd_scan_tile"]``
    only. On a CPU tensor, the plain version."""
    chunk = min(chunk, x.shape[1])
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm)
    with torch.no_grad():
        return _launch_tile(x, dt, A, Bm, Cm, chunk)
