"""The cluster decode face's schedule and algebra on the CPU: the host's
``decode_plan`` (cluster size and ring from shapes alone) and the chunks
it deals to each CTA and warp group (``decode_shares``), the route
``decode_face``, and ``paged_attention_cluster_plain``, the face's
arithmetic in PyTorch (per-warp online softmax over its 16-slot chunks,
the warp groups merged (0 with 2) with (1 with 3), the CTAs merged in
rank order, P times the v scale rounded to bf16 before P.V), against
``paged_attention_plain`` and the JAX package's interpret-mode
``_mq_paged_kernel``. The kernel itself runs on the card
(tests/test_torch_cuda.py).

Tolerances: the emulation with p in f32 at 1e-5 relative / 1e-6 absolute
(summation order only); with p rounded to bf16 at 1e-2 (p has 8 bits of
mantissa; the output is a convex sum of rows of V with O(1) entries).
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro.models import kv_quant as j_kvq  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from torch_parity import F32, decode_case, to_np  # noqa: E402

BF16_P = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("bp", [1, 8, 32, 256, 288])
@pytest.mark.parametrize("heads", [1, 8, 32, 128, 512, 4096])
def test_plan_deals_each_chunk_once(heads, bp, page):
    """Every 16-slot chunk of a full row goes to exactly one (CTA, warp
    group), in order within each; the CTA of chunk c is c % S, its place
    there c // S, its group (c // S) % 4. So any length's live chunks
    (those before ceil(len / 16)) are dealt once, and the CTAs' counts
    differ by at most one: the lengths only decide where each list ends."""
    plan = pa.decode_plan(bp, heads, page)
    S, n = plan["cluster"], plan["chunks"]
    assert n == -(-bp * page // pa.DECODE_CHUNK)
    assert 1 <= S <= min(pa.MAX_CLUSTER, n)
    assert S * heads <= max(heads, pa.CLUSTER_TARGET_CTAS)
    share = -(-n // S)     # a CTA's chunks of a full row
    assert plan["stages"] == min(share, pa.MAX_STAGES)
    assert plan["stages"] == share or plan["stages"] % pa.WARP_GROUPS == 0
    shares = pa.decode_shares(plan)
    assert len(shares) == S and all(len(g) == pa.WARP_GROUPS for g in shares)
    dealt = sorted(c for cta in shares for grp in cta for c in grp)
    assert dealt == list(range(n))
    for r, cta in enumerate(shares):
        for w, grp in enumerate(cta):
            assert grp == sorted(grp)
            assert all(c % S == r and (c // S) % pa.WARP_GROUPS == w
                       for c in grp)
    for length in (0, 1, 15, 16, 17, bp * page // 2, bp * page):
        if length > bp * page:
            continue
        live = -(-length // pa.DECODE_CHUNK)
        counts = [sum(c < live for grp in cta for c in grp) for cta in shares]
        assert sum(counts) == live and max(counts) - min(counts) <= 1


def test_plan_reads_shapes_only():
    """The plan is a function of (bp, heads, page): the serve's 128
    (lane, kv head) pairs over 32-page rows take 2 CTAs each (256 CTAs,
    2 per SM), mixtral's 32 over 288 pages the portable cap of 8,
    zamba2's 512 one; a CTA's share of seamless's 8-page rows fits the
    ring whole."""
    assert pa.decode_plan(32, 16 * 8, 16) == {"cluster": 2, "stages": 4,
                                              "chunks": 32}
    assert pa.decode_plan(288, 4 * 8, 16)["cluster"] == 8
    assert pa.decode_plan(32, 16 * 32, 16)["cluster"] == 1
    assert pa.decode_plan(8, 8 * 16, 16) == {"cluster": 2, "stages": 4,
                                             "chunks": 8}
    assert pa.decode_plan(8, 8 * 16, 32) == {"cluster": 2, "stages": 4,
                                             "chunks": 16}
    assert pa.decode_plan(4, 64, 16) == {"cluster": 4, "stages": 1,
                                         "chunks": 4}


def test_face_routes_by_dtype_and_head_dim():
    bf, f32 = torch.bfloat16, torch.float32
    for page in (8, 16, 32, 64):
        for pool in (bf, torch.int8, torch.float8_e4m3fn):
            for hd in (64, 80, 128):
                assert pa.decode_face(bf, pool, hd, page) == "cluster"
            assert pa.decode_face(bf, pool, 32, page) == "split"
            assert pa.decode_face(f32, pool, 128, page) == "split"
        assert pa.decode_face(bf, f32, 128, page) == "split"
        assert pa.decode_face(f32, f32, 64, page) == "split"


@pytest.mark.parametrize("page", [4, 24, 40, 1, 2, 12])
def test_face_routes_other_pages_to_the_split_face(page):
    """The cluster face takes pages of 8 slots or a multiple of 16 (one
    TMA box per page, 16-slot chunks); the JAX kernel and ``decode_kernel``
    take any page, so every other page goes to the split face."""
    bf = torch.bfloat16
    for pool in (bf, torch.int8, torch.float8_e4m3fn):
        for hd in (32, 64, 80, 128):
            assert pa.decode_face(bf, pool, hd, page) == "split"


def _edges(page, bp):
    full = page * bp
    return [0, 1, page - 1, page, page + 1, 16, 17, full // 2, full - 1,
            full]


# (B, H, KVH, hd, page, bp): bp 32 and 256, pages 8/16/32, G 1/2/3/4/12/48,
# hd 64/80/128
SHAPES = [
    (10, 32, 8, 128, 16, 32),    # qwen3 (G 4)
    (10, 32, 32, 80, 8, 32),     # zamba2 (G 1)
    (10, 16, 8, 64, 32, 32),     # G 2
    (10, 24, 8, 128, 16, 32),    # phi4-mini (G 3)
    (10, 24, 2, 64, 8, 32),      # starcoder2 (G 12)
    (10, 48, 1, 128, 32, 32),    # granite-20b (G 48)
    (10, 8, 2, 64, 16, 256),     # long rows
    (10, 4, 4, 80, 32, 256),
]


@pytest.mark.parametrize("B,H,KVH,hd,page,bp", SHAPES)
def test_emulation_matches_plain(B, H, KVH, hd, page, bp):
    jargs, targs = decode_case(3, B, H, KVH, hd, page, bp,
                               lens=_edges(page, bp))
    scale = 1.0 / math.sqrt(hd)
    want = pa.paged_attention_plain(*targs, scale)
    exact = pa.paged_attention_cluster_plain(*targs, scale, p_dtype=None)
    rounded = pa.paged_attention_cluster_plain(*targs, scale)
    np.testing.assert_allclose(to_np(exact), to_np(want), **F32)
    np.testing.assert_allclose(to_np(rounded), to_np(want), **BF16_P)
    assert torch.all(rounded[0] == 0) and torch.all(exact[0] == 0)


def _quant_case(kv_dtype, B, H, KVH, hd, page, bp, lens):
    """JAX-quantized pools, the same codes and scales as torch tensors."""
    rs = np.random.RandomState(11)
    NB = B * bp + 1
    jd = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv_dtype]
    td = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv_dtype]
    pools = []
    for _ in range(2):
        codes, scales = j_kvq.quantize_pages(
            jnp.asarray(rs.randn(NB, page, KVH, hd).astype(np.float32)), jd)
        t = torch.from_numpy(np.array(np.asarray(codes).view(np.uint8)))
        pools.append((codes, scales, t.view(td),
                      torch.from_numpy(np.array(scales))))
    q = rs.randn(B, H, hd).astype(np.float32)
    bt = (rs.permutation(NB - 1)[:B * bp] + 1).reshape(B, bp).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = pools
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens))
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
             torch.from_numpy(lens))
    return jargs, (jks, jvs), targs, (tks, tvs)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("B,H,KVH,hd,page,bp", [
    (10, 32, 8, 128, 16, 32), (10, 48, 1, 64, 8, 32),
    (10, 12, 4, 80, 32, 256)])
def test_emulation_folds_scales(kv_dtype, B, H, KVH, hd, page, bp):
    """Over int8/fp8 codes the emulation folds k scales into the scores
    and v scales into p (never into the codes); the plain version
    dequantizes the pages."""
    _, _, targs, (ks, vs) = _quant_case(kv_dtype, B, H, KVH, hd, page, bp,
                                        _edges(page, bp))
    scale = 1.0 / math.sqrt(hd)
    want = pa.paged_attention_plain(*targs, scale, ks, vs)
    exact = pa.paged_attention_cluster_plain(*targs, scale, ks, vs,
                                             p_dtype=None)
    rounded = pa.paged_attention_cluster_plain(*targs, scale, ks, vs)
    np.testing.assert_allclose(to_np(exact), to_np(want), **F32)
    np.testing.assert_allclose(to_np(rounded), to_np(want), **BF16_P)
    assert torch.all(rounded[0] == 0)


@pytest.mark.parametrize("pool", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("B,H,KVH,hd,page,bp", [
    (4, 8, 2, 64, 16, 4), (4, 48, 1, 128, 8, 4), (4, 3, 1, 80, 32, 2)])
def test_emulation_matches_pallas_interpret(pool, B, H, KVH, hd, page, bp):
    """The emulation against the JAX package's ``_mq_paged_kernel`` in
    interpret mode (f32 queries; the Pallas kernel keeps p in f32):
    lengths 0, 1, a page edge and a full row."""
    lens = [0, 1, page, page * bp][:B]
    scale = 1.0 / math.sqrt(hd)
    if pool == "f32":
        jargs, targs = decode_case(7, B, H, KVH, hd, page, bp, lens=lens)
        jsc, tsc = {}, (None, None)
    else:
        jargs, (jks, jvs), targs, tsc = _quant_case(pool, B, H, KVH, hd, page,
                                                    bp, lens)
        jsc = dict(k_scale=jks, v_scale=jvs)
    kern = j_paged(*jargs, scale=scale, interpret=True, **jsc)
    exact = pa.paged_attention_cluster_plain(*targs, scale, *tsc,
                                             p_dtype=None)
    rounded = pa.paged_attention_cluster_plain(*targs, scale, *tsc)
    np.testing.assert_allclose(to_np(exact), to_np(kern), **F32)
    np.testing.assert_allclose(to_np(rounded), to_np(kern), **BF16_P)
