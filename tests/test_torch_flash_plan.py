"""The flash kernel's schedule and route (``kernels/flash_attention.py``
``flash_plan``, the host's copy of the kernel's ``Tiles``; ``flash_face``
and ``flash_rows``), and the arithmetic of its f32 face, on the CPU.

For every CTA the plan must visit exactly the key tiles that hold a pair
visible to one of its live rows, and mark a tile mask-free exactly when
every pair in it is visible: the kernel skips the mask there. Each
consumer warpgroup of 64 rows computes the CTA's tiles, mask-free exactly
where every pair of its own live rows is visible. The mask is ``attention_mask``,
the one ``flash_attention_plain`` applies, and one case holds the plain
version to the JAX package's interpret-mode kernel at a windowed shape,
so the oracle of the plan is the reference's. The f32 face's 3xTF32
products are emulated with TF32 rounding done on the bits (round to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``). The kernel itself
runs on the card (tests/test_torch_cuda.py).

Tolerances: the 3xTF32 emulation at the f32 face's 1e-4 (absolute and
relative) against the plain version; the plain version against the
Pallas kernel at 1e-5 (f32, summation order only).
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from torch_parity import pair, to_np  # noqa: E402

# (causal, window): causal, under a window (edge mid-tile, on a tile
# boundary, one key past one, of one key), no mask, a window with no
# causal mask (one of width 0 leaves the last row no key)
MASKS = [(True, None), (True, 100), (True, 128), (True, 63), (True, 1),
         (False, None), (False, 50), (False, 63), (False, 0)]


def _check(S, rows, causal, window, key_tile=None):
    kt = key_tile or rows
    mask = fa.attention_mask(S, causal, window, "cpu")
    tiles = -(-S // kt)
    padded = torch.zeros(S, tiles * kt, dtype=torch.bool)
    padded[:, :S] = mask
    padded = padded.reshape(S, tiles, kt)      # [rows, tiles, kt]
    plan = fa.flash_plan(S, rows, causal, window, key_tile)
    assert [c["rows"] for c in plan] == [(q0, min(S, q0 + rows))
                                         for q0 in range(0, S, rows)]

    def masks_exactly(got, r0, r1):
        if r0 == r1:   # no live row (past a ragged S): nothing is stored
            assert all(masked for _, masked in got)
            return
        full = padded[r0:r1].all(2).all(0)
        for t, masked in got:
            assert masked == (not bool(full[t])), (r0, r1, t)

    for cta in plan:
        q0, q1 = cta["rows"]
        needed = padded[q0:q1].any(2).any(0).nonzero().flatten().tolist()
        assert [t for t, _ in cta["tiles"]] == needed, (q0, cta)
        masks_exactly(cta["tiles"], q0, q1)
        assert len(cta["groups"]) == rows // 64
        for j, group in enumerate(cta["groups"]):
            # each warpgroup computes the CTA's tiles, with its own masks
            assert [t for t, _ in group] == needed
            masks_exactly(group, min(q0 + 64 * j, q1),
                          min(q0 + 64 * j + 64, q1))


@pytest.mark.parametrize("rows,key_tile", [(64, None), (128, None),
                                           (128, 64)])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("S", [64, 256, 384, 100, 200, 129])
def test_plan_visits_exactly_the_visible_tiles(S, causal, window, rows,
                                               key_tile):
    """S a multiple of 128, S 64, and ragged S (a partial last tile, a
    last CTA of under 64 rows whose second warpgroup holds none, one of a
    single row); the
    wgmma face's tiles (as many keys as rows) and the other faces' (64
    keys in CTAs of 128 rows)."""
    _check(S, rows, causal, window, key_tile)


def test_plan_at_the_main_paths_shapes():
    """forward_kernel's S 2048 (causal), forward_mixtral's S 8192 under
    the 4096 window, forward_seamless's S 512: the interior tiles are
    mask-free, and a causal CTA of 128 rows masks only its diagonal tile
    of 128 keys (64-key tiles: two, each warpgroup masking one and the
    first computing the other masked whole)."""
    for S, rows, window in ((2048, 128, None), (8192, 128, 4096),
                            (512, 64, None)):
        _check(S, rows, True, window)
    last = fa.flash_plan(2048, 128, True)[-1]
    assert [t for t, m in last["tiles"] if m] == [15]
    assert [[t for t, m in g if m] for g in last["groups"]] == [[15], [15]]
    last = fa.flash_plan(2048, 128, True, key_tile=64)[-1]
    assert [t for t, m in last["tiles"] if m] == [30, 31]
    assert [[t for t, m in g if m] for g in last["groups"]] == [[30, 31],
                                                                 [31]]


@pytest.mark.parametrize("H,S,hd,dtype,rows", [
    (32, 2048, 128, torch.bfloat16, 128),   # forward_kernel (qwen3)
    (32, 8192, 128, torch.bfloat16, 128),   # forward_mixtral, windowed
    (16, 512, 64, torch.bfloat16, 64),      # forward_seamless: 64 CTAs
    (32, 2048, 80, torch.bfloat16, 128),    # forward_zamba2
    (32, 2048, 80, torch.float32, 0),       # f32: the 3xTF32 face
    (4, 256, 32, torch.bfloat16, 0),        # hd 32: the mma.sync tile
    (32, 512, 64, torch.bfloat16, 64),      # 128 CTAs of 128: 4 SMs idle
    (33, 512, 64, torch.bfloat16, 128),     # 132 CTAs of 128 rows
])
def test_rows_route(H, S, hd, dtype, rows):
    assert fa.flash_rows(H, S, hd, dtype) == rows


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_face_route_by_head_dim_and_dtype(hd):
    assert fa.flash_face(hd, torch.float32) == "f32_tc"
    assert fa.flash_face(hd, torch.bfloat16) == (
        "tile" if hd == 32 else "wgmma")
    # the route never reads the shape: every (B*H, S) of one face agrees
    faces = {fa.flash_rows(bh, S, hd, torch.bfloat16) > 0
             for bh in (1, 16, 64) for S in (64, 512, 4096)}
    assert faces == {hd != 32}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the bits: keep 10 mantissa bits, rounding to
    nearest with ties away from zero (the sign bit is untouched)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 face takes it: a_small b_big + a_big b_small +
    a_big b_big, each a product of TF32 values (exact in f32), summed in
    f32."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def _emulate_f32(q, k, v, causal, window, matmul):
    """The f32 face's schedule in PyTorch, one head: per CTA of 128 rows,
    the plan's tiles only, the mask only where it marks one, the online
    softmax of the tile (exp2 of the scaled scores), products by
    ``matmul``."""
    S, hd = q.shape
    c = 1.0 / math.sqrt(hd) * 1.4426950408889634
    mask = fa.attention_mask(S, causal, window, "cpu")
    out = torch.zeros(S, hd)
    for cta in fa.flash_plan(S, 128, causal, window, key_tile=64):
        q0, q1 = cta["rows"]
        m = torch.full((q1 - q0, 1), -1e30)
        l = torch.zeros(q1 - q0, 1)
        o = torch.zeros(q1 - q0, hd)
        for t, masked in cta["tiles"]:
            k0, k1 = t * 64, min(S, t * 64 + 64)
            s = matmul(q[q0:q1], k[k0:k1].T)
            vis = mask[q0:q1, k0:k1]
            if masked:
                s = torch.where(vis, s, torch.tensor(-1e30))
            else:   # the kernel applies no mask here
                assert bool(vis.all())
            mx = torch.maximum(m, s.max(1, keepdim=True).values)
            base = torch.where(mx == -1e30, 0.0, mx * c)
            alpha = torch.exp2(m * c - base)
            p = torch.exp2(s * c - base)
            l = l * alpha + p.sum(1, keepdim=True)
            o = o * alpha + matmul(p, v[k0:k1])
            m = mx
        out[q0:q1] = o / torch.where(l == 0, 1.0, l)
    return out


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)])
def test_3xtf32_schedule_holds_the_f32_tolerance(causal, window):
    """H 2, S 256, hd 80 (zamba2's head dim): the f32 face's arithmetic
    against the plain version within 1e-4; one TF32 product per f32
    product (plain TF32) misses that tolerance, which is why the face
    takes three."""
    H, S, hd = 2, 256, 80
    rs = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rs.randn(1, H, S, hd).astype(np.float32))
               for _ in range(3))
    want = fa.flash_attention_plain(q, k, v, causal, window)[0]
    got = torch.stack([_emulate_f32(q[0, h], k[0, h], v[0, h], causal,
                                    window, _matmul_3xtf32)
                       for h in range(H)])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    tf32 = torch.stack([_emulate_f32(q[0, h], k[0, h], v[0, h], causal,
                                     window,
                                     lambda a, b: _tf32(a) @ _tf32(b))
                        for h in range(H)])
    assert (tf32 - want).abs().max().item() > 1e-4


def test_plain_mask_is_the_reference_kernels():
    """The JAX package's Pallas kernel (interpret mode) at a small
    windowed shape against the port's plain version, which applies
    ``attention_mask``: the window's edge mid-tile, with and without the
    causal mask."""
    rs = np.random.RandomState(5)
    arrs = [rs.randn(1, 2, 256, 64).astype(np.float32) for _ in range(3)]
    jargs, targs = zip(*(pair(a) for a in arrs))
    for causal in (True, False):
        want = j_flash(*jargs, causal=causal, window=100, interpret=True)
        got = fa.flash_attention_plain(*targs, causal=causal, window=100)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5,
                                   atol=1e-5)
