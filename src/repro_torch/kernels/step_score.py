"""Fused STEP scorer (2-layer MLP + sigmoid): the plain PyTorch version and
the wrapper of the hand-written CUDA kernel (``csrc/step_score.cu``).

The kernel replaces the TPU kernel
``src/repro/kernels/step_score.py::_scorer_kernel``. The engine fuses it
into every decode iteration of the kernel path: the [B, D] decode-batch
hiddens feed both matmuls without the [B, 512] activations going through
device memory.

The kernel is one grid over the card (:func:`score_plan`): a cluster of
CTAs per hidden tile of 32 units, its CTAs splitting D on SMs of their
own, W1 brought by TMA, the products on the tensor cores at about f32's
accuracy (a bf16 h times W1 in three bf16 pieces, an f32 h in 3xTF32);
the partial pre-activations merged inside the cluster in rank order. A
one-CTA second launch, a programmatic dependent of the first, sums the
tiles' partial logits in tile order (deterministic: no float atomics).
:func:`step_score_face_plain` is that arithmetic in PyTorch. On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. Each call that launches adds one to
``LAUNCHES["step_score"]``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import mm_3xtf32

LAUNCHES = {"step_score": 0}
WARPS = 8             # csrc/step_score.cu: NW, warps per CTA
HIDDEN_TILE = 32      # HT: hidden units per cluster
MAX_CLUSTER = 8       # portable cluster size
MAX_ROWS = 256        # W1 rows per warp and pass: one TMA box
K_STEP = 8            # W1 rows per tensor-core product (m16n8k8)
LANE_TILES = (16, 32, 64)   # lanes per pass through a CTA
MAX_SMEM = 232448     # 227 KB of dynamic shared memory per CTA
# the least shared memory a CTA asks for, so that it takes an SM of its own
# (two CTAs of a cluster on one SM measured slower than clusters on
# distinct SMs)
ONE_PER_SM = 118784
# clusters of 1..8 CTAs an H100 SXM runs at once at one CTA per SM
# (cudaOccupancyMaxActiveClusters; its GPCs hold 120 SMs' worth of
# clusters of 4 or 8, 102 of 6); the wrapper asks the card for its own
H100_FITS = (132, 66, 39, 30, 22, 17, 15, 15)
_lib = None
_fits: dict = {}


def step_score_plain(hidden: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """hidden [B, D] -> scores [B] = sigmoid(relu(h @ w1 + b1) @ w2 + b2),
    all in f32."""
    z = torch.relu(hidden.float() @ w1 + b1)
    return torch.sigmoid((z @ w2 + b2)[..., 0])


# ---------------------------------------------------------------------------
# the kernel's launch plan, from shapes and the SM count alone, and its sum
# order in PyTorch
# ---------------------------------------------------------------------------

def h_words(rows: int, h_bytes: int = 4) -> int:
    """4-byte words per lane of a warp's h rows in shared memory
    (``h_words`` in ``csrc/step_score.cu``): whole product steps (16 rows
    of bf16, 8 of f32), at least the hidden tile (the warp's partials
    overlay them), and a stride of 4 mod 8 words (no bank conflict)."""
    step = 16 if h_bytes == 2 else 8
    need = -(-(-(-rows // step) * step * h_bytes) // 4)
    n = max(need, HIDDEN_TILE)
    return n + (12 - n % 8) % 8


def score_smem(rows: int, lane_tile: int, cluster: int,
               h_bytes: int = 4) -> int:
    """The kernel's dynamic shared memory in bytes (``Smem`` in
    ``csrc/step_score.cu``) for h of ``h_bytes``-byte values: the warps'
    mbarriers, the W1 boxes (whole 1 KB swizzle atoms each), each warp's
    h rows (its partials over them) and the partials the cluster pushes;
    at least :data:`ONE_PER_SM`."""
    nq = -(-lane_tile // cluster)
    w1_rows = -(-rows // 8) * 8   # whole 1 KB swizzle atoms per box
    return max(ONE_PER_SM, 1024 + WARPS * w1_rows * HIDDEN_TILE * 4
               + WARPS * lane_tile * h_words(rows, h_bytes) * 4
               + cluster * nq * HIDDEN_TILE * 4)


@functools.lru_cache(maxsize=512)
def score_plan(B: int, D: int, Hd: int, fits: tuple = H100_FITS) -> dict:
    """The grid of one call over B lanes, D rows of W1 and Hd hidden units,
    from shapes and ``fits`` (``fits[S - 1]``: the clusters of S CTAs the
    card runs at once, one CTA per SM) alone.

    One cluster per hidden tile of 32 units, its CTAs splitting D: the
    largest cluster (up to 8) of which the card runs all the tiles' at
    once on distinct SMs, so that the W1 read spreads over the card in one
    wave, while each warp keeps a product step of 8 rows. The CTA's rows
    split into 8 warps' ``rows`` (one TMA box each, whole 8-row steps past
    8), in ``passes`` where a box would pass 256 rows or the CTA's shared
    memory 227 KB (``smem``: that of f32 hidden states, which bf16 ones
    never pass); lanes go through the CTA in tiles of 16, 32 or 64.
    Returns {"cluster", "tiles", "hidden_tile", "rows", "passes",
    "rows_per_cta", "lane_tile", "lane_tiles", "ctas", "smem"}."""
    if Hd % HIDDEN_TILE or not HIDDEN_TILE <= Hd <= 1024 or B < 1 or D < 1:
        raise ValueError(f"step_score: no plan for B {B}, D {D}, Hd {Hd}")
    tiles = Hd // HIDDEN_TILE
    cluster = max([1] + [S for S in range(2, MAX_CLUSTER + 1)
                         if fits[S - 1] >= tiles
                         and S * WARPS * K_STEP <= D])
    lane_tile = next((t for t in LANE_TILES if t >= B), LANE_TILES[-1])
    per_warp = -(-(-(-D // cluster)) // WARPS)
    passes = 0
    while True:
        passes += 1
        rows = -(-per_warp // passes)
        if rows > K_STEP:
            rows = -(-rows // K_STEP) * K_STEP
        smem = score_smem(rows, lane_tile, cluster)
        if rows <= MAX_ROWS and smem <= MAX_SMEM:
            break
    return {"cluster": cluster, "tiles": tiles, "hidden_tile": HIDDEN_TILE,
            "rows": rows, "passes": passes,
            "rows_per_cta": passes * WARPS * rows, "lane_tile": lane_tile,
            "lane_tiles": -(-B // lane_tile), "ctas": cluster * tiles,
            "smem": smem}


def score_blocks(plan: dict, D: int) -> list:
    """The W1 rows each warp sums, in the kernel's order: (rank, pass,
    warp, first row, rows) for every box with rows below D."""
    rows, span = plan["rows"], WARPS * plan["rows"]
    out = []
    for rank in range(plan["cluster"]):
        for p in range(plan["passes"]):
            for w in range(WARPS):
                r0 = (rank * plan["passes"] + p) * span + w * rows
                if r0 < D:
                    out.append((rank, p, w, r0, min(rows, D - r0)))
    return out


def split_bf16x3(w: torch.Tensor):
    """(hi, mid, lo) as f32: three bf16 pieces of f32 ``w``, each the
    round-to-nearest bf16 of what the others leave (``split3`` in
    ``csrc/step_score.cu``); hi + mid + lo is ``w`` to f32's precision."""
    out, r = [], w.float()
    for _ in range(3):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return tuple(out)


def step_score_face_plain(hidden: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, plan: dict = None
                          ) -> torch.Tensor:
    """The kernel's sum order in PyTorch, in f32: each warp's rows summed
    over its passes (products as the tensor cores take them: bf16 h times
    W1 in three bf16 pieces, or f32 h in 3xTF32), the warps of a CTA in
    warp order, the CTAs of a cluster in rank order; b1, ReLU and W2 per
    unit; each tile's 32 units summed to a partial logit; the tiles summed
    in tile order; b2 and the sigmoid."""
    B, D = hidden.shape
    Hd = w1.shape[1]
    plan = plan or score_plan(B, D, Hd)
    bf16 = hidden.dtype == torch.bfloat16
    h, w1 = hidden.float(), w1.float()
    pieces = split_bf16x3(w1) if bf16 else None
    parts = {}
    for rank, _, w, r0, n in score_blocks(plan, D):
        key = (rank, w)
        if bf16:   # the small pieces first
            lo, mid, hi = (x[r0:r0 + n] for x in reversed(pieces))
            part = (h[:, r0:r0 + n] @ lo + h[:, r0:r0 + n] @ mid) \
                + h[:, r0:r0 + n] @ hi
        else:
            part = mm_3xtf32(h[:, r0:r0 + n], w1[r0:r0 + n])
        parts[key] = parts[key] + part if key in parts else part
    z = torch.zeros((B, Hd), dtype=torch.float32, device=hidden.device)
    for rank in range(plan["cluster"]):
        cta = None
        for w in range(WARPS):
            if (rank, w) in parts:
                cta = parts[(rank, w)] if cta is None \
                    else cta + parts[(rank, w)]
        if cta is not None:
            z = z + cta
    a = torch.relu(z + b1) * w2[:, 0]
    logits = a.reshape(B, plan["tiles"], HIDDEN_TILE).sum(-1)
    s = torch.zeros(B, dtype=torch.float32, device=hidden.device)
    for t in range(plan["tiles"]):
        s = s + logits[:, t]
    return torch.sigmoid(s + b2)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        lib = build.load("step_score")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_step_score.argtypes = [p] * 7 + [i] * 8 + [p]
        lib.repro_step_score.restype = i
        lib.repro_step_score_smem.argtypes = [i] * 4
        lib.repro_step_score_smem.restype = i
        lib.repro_step_score_max_clusters.argtypes = [i] * 3
        lib.repro_step_score_max_clusters.restype = i
        _lib = lib
    return _lib


def card_fits(device: torch.device) -> tuple:
    """``score_plan``'s ``fits`` for this card: the clusters of 1..8 CTAs
    it runs at once at one CTA per SM (cudaOccupancyMaxActiveClusters),
    asked once per device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _fits:
        lib = _library()
        with torch.cuda.device(index):
            _fits[index] = tuple(
                lib.repro_step_score_max_clusters(K_STEP, LANE_TILES[0], S)
                for S in range(1, MAX_CLUSTER + 1))
    return _fits[index]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"step_score kernel: {msg}")


def step_score(hidden: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """hidden [B, D] (bf16 or f32); w1 [D, Hd], b1 [Hd], w2 [Hd, 1],
    b2 [1] f32. Returns scores [B] f32 in [0, 1]. On a CUDA tensor:
    checks the operands and launches the kernel on the current stream at
    :func:`score_plan`'s grid for this card."""
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
    if w1.data_ptr() % 16:  # TMA reads W1 from a 16-byte aligned base
        w1 = w1.clone()
    lib = _library()
    device = hidden.device
    plan = score_plan(B, D, Hd, card_fits(device))
    out = torch.empty((B,), dtype=torch.float32, device=device)
    # each hidden tile's partial logits
    logits = torch.empty((plan["tiles"], B), dtype=torch.float32,
                         device=device)
    err = lib.repro_step_score(
        hidden.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), logits.data_ptr(), B, D, Hd,
        int(hidden.dtype == torch.bfloat16), plan["cluster"], plan["rows"],
        plan["passes"], plan["lane_tile"],
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"step_score kernel launch failed: CUDA error {err}")
    LAUNCHES["step_score"] += 1
    return out
