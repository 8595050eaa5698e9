"""The SSD scan's wgmma face (kernel K4 on Hopper) on the CPU: its route
``ssd_face`` (shapes alone), its output launch's plan (``ssd_plan``, the
head group from shapes and the SM count, and ``ssd_items``, the CTAs in
launch order), the tf32 rounding of its 3xTF32 products, and
``ssd_wgmma_plain``, the face's algebra launch by launch in PyTorch
(head-grouped CTAs over 64-row tiles, L formed only where j <= i, w_j
folded into the state product's A operand, the state passing in chunk
order, the carry-in's rows scaled by exp(cs_i), every product split into
tf32 halves rounded to nearest as ``cvt.rna`` rounds), held to
``ssd_scan_plain``, ``ref.ssd_scan_ref`` (the sequential oracle) and the
JAX package's Pallas ``ssd_scan`` in interpret mode, as
tests/test_torch_ssd.py runs it. The kernel itself runs on the card
(tests/test_torch_cuda.py).

Tolerances: against the oracle (and the plain version, the same
recurrence) 1e-5 relative plus 1e-4 absolute: 3xTF32 keeps about f32's
accuracy (the dropped small-by-small term is ~2^-22 of a product), and
outputs reach ~4e2; against the Pallas kernel 2e-3, as
tests/test_kernels.py holds the Pallas kernel to the oracle (the chunked
form exponentiates cumsum differences instead of multiplying per-step
decays). With the init's steep decays (cs hundreds below zero, where one
f32 ulp of cs is ~3e-5 of an exponent) the chunked forms are held to the
oracle at 2e-3 too, as tests/test_torch_ssd.py holds them. At the full
width (80 heads, P 64, N 128, chunks of 256, outputs reaching ~3e2) the
absolute part is 1e-5 of the largest output: there the port's own dense
``ssd_chunked`` in f32 parts from the oracle by 1.5e-3 (f32 sums over 256
positions and 128 states), and the emulation is held to stay nearer.
"""
import math

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro_torch.kernels import ssd_scan as sd  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from torch_parity import to_np  # noqa: E402

ORACLE = dict(rtol=1e-5, atol=1e-4)
CHUNKED = dict(rtol=2e-3, atol=2e-3)
# tests/test_torch_ssd.py's SHAPES: (B, S, H, P, N, chunk, head_group)
SHAPES = [(1, 64, 2, 8, 16, 16, 1), (2, 128, 6, 16, 32, 32, 3),
          (1, 256, 4, 32, 64, 128, 4), (2, 96, 5, 16, 32, 32, 4)]
# tests/test_torch_cuda.py's test_ssd_kernel_matches_plain:
# (B, S, H, P, N, chunk, stress)
CARD = [(1, 64, 2, 8, 16, 16, False), (2, 128, 6, 16, 32, 32, False),
        (1, 256, 4, 32, 64, 128, False), (2, 96, 5, 16, 32, 32, False),
        (2, 33, 8, 32, 16, 64, False), (1, 512, 80, 64, 128, 256, True),
        (2, 64, 8, 32, 16, 32, True), (1, 4096, 80, 64, 128, 256, True),
        (2, 512, 80, 64, 128, 256, False), (1, 2048, 80, 64, 64, 256, True),
        (2, 96, 8, 32, 16, 32, True)]


def _inputs(seed, B, S, H, P, N, stress=False):
    """x, dt, A, Bm, Cm as numpy f32. ``stress``: the init's decay rates
    A = -(1..H) and large steps, so cs falls hundreds below zero inside a
    chunk."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, H, P)
    dt = np.log1p(np.exp(rs.randn(B, S, H) + (2.0 if stress else 0.0)))
    A = -np.arange(1, H + 1) if stress else -np.exp(rs.randn(H))
    Bm, Cm = rs.randn(B, S, N), rs.randn(B, S, N)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("B,S,H,P,N,chunk,g", SHAPES)
def test_jax_test_shapes_take_the_tile_face(B, S, H, P, N, chunk, g):
    assert sd.ssd_face(P, N, min(chunk, S)) == "tile"


@pytest.mark.parametrize("B,S,H,P,N,chunk,stress", CARD)
def test_card_shapes_route_by_shape(B, S, H, P, N, chunk, stress):
    """Every full-width shape (P 64, N 64 or 128, chunk 256) takes the
    wgmma face; the JAX tests' shapes and a chunk of 33 the tile face."""
    face = sd.ssd_face(P, N, min(chunk, S))
    assert face == ("wgmma" if P == 64 and N in (64, 128) else "tile")


def test_face_route_edges():
    for N in (64, 128):
        for chunk in (64, 128, 192, 256):
            assert sd.ssd_face(64, N, chunk) == "wgmma"
        for chunk in (16, 32, 33, 96, 100, 320, 512):
            assert sd.ssd_face(64, N, chunk) == "tile"
    for P, N in ((32, 128), (128, 128), (64, 32), (64, 256), (8, 16)):
        assert sd.ssd_face(P, N, 256) == "tile"


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 2048, 80, 128, 256), (1, 2048, 80, 64, 256), (1, 2048, 80, 128, 128),
    (2, 512, 80, 128, 256), (1, 4096, 80, 128, 256), (2, 384, 8, 128, 192),
    (1, 256, 3, 64, 64), (1, 1024, 80, 64, 128)])
def test_plan_covers_every_tile_once_longest_first(B, S, H, N, chunk):
    """The output launch's CTAs: one per (b, chunk, head group, tile),
    dispatched with the tiles of the most key blocks first, every
    (b, chunk, head, 64-row tile) exactly once; G divides H and the
    plan's makespan is the least of its candidates'."""
    plan = sd.ssd_plan(B, S, H, N, chunk)
    G = plan["G"]
    assert H % G == 0 and 1 <= G <= 32
    items = sd.ssd_items(B, S, H, chunk, G)
    assert len(items) == plan["items"] == B * (S // chunk) * (H // G) * (
        chunk // 64)
    tiles = [t for _, _, _, t in items]
    assert tiles == sorted(tiles, reverse=True)
    seen = {(b, c, hg * G + k, t) for b, c, hg, t in items for k in range(G)}
    assert len(seen) == B * (S // chunk) * H * (chunk // 64)
    for other in (d for d in range(1, min(H, 32) + 1) if H % d == 0):
        free = [0] * sd.SMS
        for b, c, hg, t in sd.ssd_items(B, S, H, chunk, other):
            k = free.index(min(free))
            free[k] += sd._item_cost(c, t, other, N // 64)
        assert max(free) >= plan["makespan"]


def test_plan_uses_the_sm_count():
    """Fewer SMs, another schedule: the plan reads the card's count."""
    a = sd.ssd_plan(1, 2048, 80, 128, 256, 132)
    b = sd.ssd_plan(1, 2048, 80, 128, 256, 66)
    assert a["makespan"] < b["makespan"]


def test_tf32_round_is_cvt_rna():
    """Ten mantissa bits, to nearest, ties away from zero; big + small
    rebuilds the value to ~2^-22 of it."""
    one = 1.0
    half_ulp = 2.0 ** -11
    v = torch.tensor([one + half_ulp, -(one + half_ulp), one + 2.0 ** -12,
                      one + 3 * half_ulp, 3.0, 0.0, -0.0, 1e-30, 6e4])
    r = sd.tf32_round(v)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 4 * half_ulp, 3.0, 0.0, -0.0,
                         float(sd.tf32_round(torch.tensor([1e-30]))[0]),
                         6e4])
    assert torch.equal(r, want)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    big, small = sd.split_tf32(x)
    assert ((big + small - x).abs() <= x.abs() * 2.0 ** -21).all()
    assert not torch.equal(big, x)


@pytest.mark.parametrize("B,S,H,P,N,chunk,g", SHAPES)
def test_emulation_matches_oracle_and_pallas(B, S, H, P, N, chunk, g):
    """The face's algebra with the Pallas kernel's head group (the last
    group short where it does not divide H) and with the plan's."""
    jargs, targs = _both(_inputs(0, B, S, H, P, N))
    yr, hr = ref.ssd_scan_ref(*jargs)
    yk, hk = j_ssd_scan(*jargs, chunk=chunk, head_group=g, interpret=True)
    yp, hp = sd.ssd_scan_plain(*targs)
    for G in (g, None):
        y, h = sd.ssd_wgmma_plain(*targs, chunk=chunk, G=G)
        np.testing.assert_allclose(to_np(y), to_np(yr), **ORACLE)
        np.testing.assert_allclose(to_np(h), to_np(hr), **ORACLE)
        np.testing.assert_allclose(to_np(y), to_np(yp), **ORACLE)
        np.testing.assert_allclose(to_np(h), to_np(hp), **ORACLE)
        np.testing.assert_allclose(to_np(y), to_np(yk), **CHUNKED)
        np.testing.assert_allclose(to_np(h), to_np(hk), **CHUNKED)


def test_emulation_steep_decays_stay_finite():
    """A = -(1..H) with large steps: cs falls hundreds below zero inside
    a chunk, so exp(cs_i - cs_j) above the diagonal overflows. L is
    formed only where j <= i: no NaN, and the oracle's values."""
    arrs = _inputs(4, 1, 256, 8, 64, 64, stress=True)
    cs = np.cumsum(arrs[1][0, :128] * arrs[2], axis=0)
    assert cs.min() < -500.0
    jargs, targs = _both(arrs)
    y, h = sd.ssd_wgmma_plain(*targs, chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    yr, hr = ref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(to_np(y), to_np(yr), **CHUNKED)
    np.testing.assert_allclose(to_np(h), to_np(hr), **CHUNKED)
    yk, hk = j_ssd_scan(*jargs, chunk=128, interpret=True)
    np.testing.assert_allclose(to_np(y), to_np(yk), **CHUNKED)
    np.testing.assert_allclose(to_np(h), to_np(hk), **CHUNKED)


def test_emulation_padded_sequence_keeps_the_state():
    """S = 200 padded to 256 with dt = 0, as the mixer pads: cs is summed
    in order, so the padded steps keep it (a decay of exactly 1) and the
    final state is the unpadded recurrence's."""
    arrs = _inputs(3, 2, 200, 4, 64, 128)
    padded = [np.pad(a, [(0, 0), (0, 56)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in arrs]
    y, h = sd.ssd_wgmma_plain(*[torch.from_numpy(a) for a in padded],
                              chunk=128)
    jargs, _ = _both(arrs)
    yr, hr = ref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(to_np(y[:, :200]), to_np(yr), **ORACLE)
    np.testing.assert_allclose(to_np(h), to_np(hr), **ORACLE)
    assert not y[:, 200:].any()
    dA = torch.from_numpy(padded[1] * padded[2])[0].T        # [H, S]
    cs = sd._cumsum_in_order(dA[:, 128:])
    assert torch.equal(cs[:, 200 - 128:], cs[:, 200 - 129:200 - 128]
                       .expand(-1, 56))


def test_emulation_at_full_heads():
    """80 heads at P 64, N 128 and a chunk of 256 over two chunks (the
    plan's head group, four 64-row tiles, the carry-in of chunk 1): the
    algebra at the kernel's widths."""
    arrs = _inputs(5, 1, 512, 80, 64, 128)
    jargs, targs = _both(arrs)
    assert sd.ssd_face(64, 128, 256) == "wgmma"
    y, h = sd.ssd_wgmma_plain(*targs, chunk=256)
    yp, hp = sd.ssd_scan_plain(*targs)
    wide = dict(rtol=1e-5, atol=1e-5 * float(yp.abs().max()))
    np.testing.assert_allclose(to_np(y), to_np(yp), **wide)
    np.testing.assert_allclose(to_np(h), to_np(hp), **ORACLE)
    yr, hr = ref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(to_np(y), to_np(yr), **wide)
    np.testing.assert_allclose(to_np(h), to_np(hr), **ORACLE)
    yd, _ = tl.ssd_chunked(*targs, chunk=256)
    assert (y - yp).abs().max() <= (yd - yp).abs().max()
    yk, hk = j_ssd_scan(*jargs, chunk=256, interpret=True)
    np.testing.assert_allclose(to_np(y), to_np(yk), **CHUNKED)
    np.testing.assert_allclose(to_np(h), to_np(hk), **CHUNKED)


def test_tf32_products_hold_f32_accuracy():
    """The same algebra with f32 products and with 3xTF32 ones agree to
    f32 rounding; one tf32 product alone would not (why the face runs
    three)."""
    _, targs = _both(_inputs(6, 1, 256, 4, 64, 128))
    y3, h3 = sd.ssd_wgmma_plain(*targs, chunk=128)
    y32, h32 = sd.ssd_wgmma_plain(*targs, chunk=128, tf32=False)
    np.testing.assert_allclose(to_np(y3), to_np(y32), **ORACLE)
    np.testing.assert_allclose(to_np(h3), to_np(h32), **ORACLE)
    a = targs[3][0, :128]
    one = sd.tf32_round(a) @ sd.tf32_round(a).T
    three = sd.mm_3xtf32(a, a.T)
    exact = (a.double() @ a.double().T)
    assert (three - exact).abs().max() < 1e-4 < (one - exact).abs().max()
    assert math.isfinite(float(three.sum()))
