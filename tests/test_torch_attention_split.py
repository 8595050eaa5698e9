"""The algebra of the redesigned attention kernels against the JAX package,
through the plain PyTorch functions kept beside the kernels in
``repro_torch/kernels/paged_attention.py``:

  * split-K decode: partial softmax states over parts of each lane's page
    range, merged by log-sum-exp (``paged_attention_split_plain``), with
    empty parts and length-0 lanes, against ``paged_attention_plain`` and
    ``repro/kernels/ref.py::paged_attention_ref``;
  * the per-slot scale folding of an int8/fp8 pool (scores of the codes
    times k_scale, p times v_scale) against ``gather_kv``'s dequantized
    path;
  * the tensor-core tile's online softmax with P rounded to bf16
    (``tiled_softmax_pv``) against the plain flash version and
    ``ref.py::mha_ref``.

Tolerances: f32 at 1e-5 (summation order only: the parts and the merge
reorder the sums). P rounded to bf16 is held to the bf16 tolerance of the
flash kernel, 1e-2 absolute plus 1e-2 relative (one bf16 ulp of p is
2^-8 relative, and the output averages those roundings).
"""
import math

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import kv_quant  # noqa: E402
from torch_parity import decode_case, pair, to_np  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_KERNEL = dict(rtol=1e-2, atol=1e-2)
QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _lens(B, page, bp):
    """Empty, one slot, a page boundary, a full row, then ragged."""
    base = [0, 1, page, bp * page, 3 * page + 5, bp * page // 2 + 1]
    return (base * ((B + len(base) - 1) // len(base)))[:B]


@pytest.mark.parametrize("splits", list(range(1, 9)))
@pytest.mark.parametrize("B,H,KVH,hd,page,bp", [
    (6, 8, 2, 64, 8, 16),
    (6, 4, 4, 32, 16, 9),
])
def test_split_pages_match_plain_and_oracle(splits, B, H, KVH, hd, page,
                                            bp):
    jargs, targs = decode_case(3, B, H, KVH, hd, page, bp,
                               lens=_lens(B, page, bp))
    scale = 1.0 / math.sqrt(hd)
    got = pa.paged_attention_split_plain(*targs, scale, splits=splits)
    want = pa.paged_attention_plain(*targs, scale)
    oracle = ref.paged_attention_ref(*jargs, scale)
    assert bool((got[0] == 0).all())   # length-0 lane: zeros
    torch.testing.assert_close(got, want, **F32)
    np.testing.assert_allclose(to_np(got), to_np(oracle), **F32)


def test_split_parts_past_the_length_are_empty():
    """A part that holds no visible slot is (m, l, acc) = (-inf, 0, 0)
    and leaves the merge unchanged, also when every part is empty."""
    scores = torch.randn(2, 3, 12)
    v = torch.randn(2, 12, 5)
    mask = torch.zeros(2, 3, 12, dtype=torch.bool)
    mask[0, :, :4] = True                       # row block 1 stays empty
    parts = [pa.softmax_partial(scores[..., s:s + 4], mask[..., s:s + 4],
                                v[:, s:s + 4]) for s in (0, 4, 8)]
    for m, l, acc in parts[1:]:
        assert bool((m == float("-inf")).all()) and bool((l == 0).all())
        assert bool((acc == 0).all())
    merged = pa.merge_partials(parts)
    want = pa.masked_softmax_pv(scores, mask, v, "bqk,bkd->bqd")
    torch.testing.assert_close(merged, want, **F32)
    assert bool((merged[1] == 0).all())


def test_split_count_reads_shapes_only():
    """The host picks the parts from the block-table width and B*KVH:
    one part where 128 CTAs already cover the card or the rows are
    short, several for long rows over few lanes, never more than one per
    32 pages."""
    assert pa.split_count(32, 16 * 8) == 1      # the serve shape
    assert pa.split_count(256, 16 * 8) == 5     # 16 long lanes
    assert pa.split_count(256, 6 * 2) == 8      # few lanes: capped by bp
    assert pa.split_count(31, 1) == 1
    for bp in (1, 32, 64, 200, 1024):
        for heads in (1, 8, 128, 4096):
            n = pa.split_count(bp, heads)
            assert 1 <= n <= max(1, bp // pa.MIN_SPLIT_PAGES)


@pytest.mark.parametrize("kv_dtype", list(QUANT))
@pytest.mark.parametrize("splits", [1, 3])
def test_scale_folding_matches_dequantized_path(kv_dtype, splits):
    """Scores of the codes times k_scale and p times v_scale equal the
    dense path's dequantize-then-attend (gather_kv), and the JAX oracle
    over the dequantized pool."""
    B, H, KVH, hd, page, bp = 6, 8, 2, 64, 16, 8
    jargs, targs = decode_case(5, B, H, KVH, hd, page, bp,
                               lens=_lens(B, page, bp))
    q, kp, vp, bt, lens = targs
    (kq, ks), (vq, vs) = (kv_quant.quantize_pages(x, QUANT[kv_dtype])
                          for x in (kp, vp))
    scale = 1.0 / math.sqrt(hd)
    got = pa.paged_attention_split_plain(q, kq, vq, bt, lens, scale, ks, vs,
                                         splits=splits)
    want = pa.paged_attention_plain(q, kq, vq, bt, lens, scale, ks, vs)
    torch.testing.assert_close(got, want, **F32)
    kd = (kq.float() * ks[..., None]).numpy()   # gather_kv's dequantization
    vd = (vq.float() * vs[..., None]).numpy()
    oracle = ref.paged_attention_ref(jargs[0], jnp.asarray(kd),
                                     jnp.asarray(vd), *jargs[3:], scale)
    np.testing.assert_allclose(to_np(got), to_np(oracle), **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None), (False, 40)])
def test_tiled_softmax_matches_plain_in_f32(causal, window):
    """Without rounding, the tile's online softmax over 64-key blocks is
    the one-pass masked softmax (and a row with no key emits zeros)."""
    rs = np.random.RandomState(0)
    S, hd = 200, 32
    scores = torch.from_numpy(rs.randn(2, S, S).astype(np.float32))
    v = torch.from_numpy(rs.randn(2, S, hd).astype(np.float32))
    mask = fa.attention_mask(S, causal, window, "cpu")
    mask[0] = False                             # a row with no key
    got = pa.tiled_softmax_pv(scores, mask, v)
    want = pa.masked_softmax_pv(scores, mask, v, "bqk,bkd->bqd")
    torch.testing.assert_close(got, want, **F32)
    assert bool((got[:, 0] == 0).all())


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, 40)])
def test_rounding_p_to_bf16_stays_in_the_bf16_tolerance(causal, window):
    """At the smoke config's attention shape (its heads and head_dim, a
    256-token sequence), P rounded to bf16 before P.V stays inside the
    bf16 tolerance of the plain flash version and of mha_ref."""
    cfg = j_serving_config()
    H, hd, S = cfg.num_heads, cfg.head_dim, 256
    rs = np.random.RandomState(1)
    arrs = [rs.randn(1, H, S, hd).astype(np.float32) for _ in range(3)]
    (jq, q), (jk, k), (jv, v) = (pair(a, "bf16") for a in arrs)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = fa.attention_mask(S, causal, window, "cpu")
    got = pa.tiled_softmax_pv(scores, mask, v, p_dtype=torch.bfloat16)
    got = got.to(torch.bfloat16)
    plain = fa.flash_attention_plain(q, k, v, causal, window)
    oracle = ref.mha_ref(jq, jk, jv, causal=causal, window=window)
    torch.testing.assert_close(got.float(), plain.float(), **BF16_KERNEL)
    np.testing.assert_allclose(to_np(got), to_np(oracle), **BF16_KERNEL)
