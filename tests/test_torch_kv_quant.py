"""The port's quantized (int8 / fp8) paged KV pool against the JAX
package: the quantizer (codes compared as bytes, scales exactly), the byte
accounting, the quantized scatters, the plain versions of the
``has_scales`` paged kernel against the interpret-mode Pallas kernel, and
greedy ``serve_batch`` of both engines.

Tolerances: the plain kernels at 1e-6 (atol and rtol), as
``tests/test_kv_quant.py`` holds the Pallas kernel against its dense
dequantization: both dequantize to exactly the same f32 operands (the
scales live on the bf16 grid), so only the summation order differs. The
engines run f32 params (the JAX engine dense); step scores and
confidences agree within 1e-4, as in ``tests/test_torch_engine.py``.
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.data.tokenizer import get_tokenizer  # noqa: E402
from repro.kernels import paged_attention as j_paged  # noqa: E402
from repro.models import kv_quant as j_kvq  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as t_paged  # noqa: E402
from repro_torch.models import kv_quant as t_kvq  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from test_torch_engine import (assert_same_results, engine_kw,  # noqa: E402
                               make_setup, serve_jax, serve_torch)

EXACT = dict(rtol=1e-6, atol=1e-6)
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _bytes(x) -> np.ndarray:
    """Codes of either package as raw bytes."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _codes_to_torch(codes) -> torch.Tensor:
    """JAX int8/fp8 codes -> the same bytes as a torch tensor."""
    arr = np.asarray(codes)
    t = torch.from_numpy(np.array(arr.view(np.uint8), copy=True))
    return t.view(torch.int8 if arr.dtype == np.int8 else torch.float8_e4m3fn)


def _values(seed, shape):
    """KV-like values over several binades, plus an all-zero vector."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape) * np.exp2(rs.randint(-6, 6, shape[:-1]))[..., None]
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0
    return x


# ---------------------------------------------------------------------------
# quantizer and byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_quantize_pages_matches_jax(kv_dtype, src):
    jd, td = QDTYPES[kv_dtype]
    x = _values(0, (3, 5, 4, 32))
    if src == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = j_kvq.quantize_pages(jx, jd)
    tq, ts = t_kvq.quantize_pages(tx, td)
    assert tq.dtype == td and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(ts.numpy().reshape(-1)[0] == 1.0)  # the all-zero vector
    np.testing.assert_array_equal(
        t_kvq.dequantize_pages(tq, ts).numpy(),
        np.asarray(j_kvq.dequantize_pages(jq, js)))


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8", "fp8"])
def test_pool_block_bytes_and_init_scales_match(kv_dtype):
    for name in ("serving", "qwen3-4b-thinking"):
        jc, tc = ((j_registry.serving_config(), t_registry.serving_config())
                  if name == "serving" else
                  (j_registry.get_config(name), t_registry.get_config(name)))
        assert t_kvq.pool_block_bytes(tc, kv_dtype) == \
            j_kvq.pool_block_bytes(jc, kv_dtype)
    jc, tc = j_registry.serving_config(), t_registry.serving_config()
    js, ts = j_kvq.init_scales(jc, 7, kv_dtype), t_kvq.init_scales(tc, 7,
                                                                    kv_dtype)
    assert (js is None) == (ts is None) == (not t_kvq.is_quantized(kv_dtype))
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert t_kvq.kv_pool_dtype(kv_dtype).itemsize == \
        jnp.dtype(j_kvq.kv_pool_dtype(kv_dtype)).itemsize


# ---------------------------------------------------------------------------
# the quantized scatters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_scatters_match_jax(kv_dtype):
    """Decode append and chunk scatter: the port's in-place writes store
    the bytes and scales the JAX package's functional writes return, in
    every slot but the scratch block 0 (where the port sends padding)."""
    jd, _ = QDTYPES[kv_dtype]
    NB, bs, KVH, hd, B, C = 9, 4, 2, 16, 2, 5
    pool0 = _values(2, (NB, bs, KVH, hd))
    jpool, jscale = j_kvq.quantize_pages(jnp.asarray(pool0), jd)
    tpool, tscale = _codes_to_torch(jpool), torch.from_numpy(
        np.array(jscale))
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    # decode: one token per lane
    new = _values(3, (B, KVH, hd))
    slots = np.array([6, 13], np.int32)
    jp2, js2 = j_layers.paged_kv_update_quant(
        jpool, jscale, jnp.asarray(bt), jnp.asarray(slots), jnp.asarray(new))
    t_layers.paged_kv_update_quant(tpool, tscale, torch.from_numpy(bt),
                                   torch.from_numpy(slots),
                                   torch.from_numpy(new))
    np.testing.assert_array_equal(_bytes(tpool), _bytes(jp2))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(js2))
    # chunk: C tokens per row from position 3, the last two of row 1 padded
    vals = _values(4, (B, C, KVH, hd))
    pos = (3 + np.arange(C))[None].repeat(B, 0).astype(np.int32)
    valid = np.ones((B, C), bool)
    valid[1, 3:] = False
    jp3, js3 = j_layers.paged_chunk_update_quant(
        jp2, js2, jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(valid),
        jnp.asarray(vals))
    t_layers.paged_chunk_update_quant(
        tpool, tscale, torch.from_numpy(bt), torch.from_numpy(pos),
        torch.from_numpy(valid), torch.from_numpy(vals))
    np.testing.assert_array_equal(_bytes(tpool)[1:], _bytes(jp3)[1:])
    np.testing.assert_array_equal(tscale.numpy()[1:], np.asarray(js3)[1:])


# ---------------------------------------------------------------------------
# plain K1c against the interpret-mode Pallas kernel with scales
# ---------------------------------------------------------------------------

def _quant_pools(seed, NB, page, KVH, hd, kv_dtype):
    jd, _ = QDTYPES[kv_dtype]
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        x = rs.randn(NB, page, KVH, hd).astype(np.float32)
        jq, js = j_kvq.quantize_pages(jnp.asarray(x), jd)
        out.append((jq, js, _codes_to_torch(jq),
                    torch.from_numpy(np.array(js))))
    return out


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("B,H,KVH,hd,page,bp", [(3, 4, 2, 32, 4, 3),
                                               (2, 8, 2, 64, 16, 2)])
def test_decode_quant_plain_matches_pallas(kv_dtype, B, H, KVH, hd, page,
                                           bp):
    rs = np.random.RandomState(5)
    NB = B * bp + 1
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _quant_pools(6, NB, page, KVH,
                                                          hd, kv_dtype)
    q = rs.randn(B, H, hd).astype(np.float32)
    bt = (rs.permutation(NB - 1)[:B * bp] + 1).reshape(B, bp) \
        .astype(np.int32)
    lens = np.array([0, page * bp, 3][:B] if B == 3 else [5, page * bp],
                    np.int32)
    scale = 1.0 / np.sqrt(hd)
    want = j_paged.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        scale=scale, interpret=True, k_scale=jks, v_scale=jvs)
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
             torch.from_numpy(lens))
    plain = t_paged.paged_attention_plain(*targs, scale, tks, tvs)
    wrapped = ops.paged_attention(*targs, scale=scale, k_scale=tks,
                                  v_scale=tvs)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **EXACT)
    assert torch.equal(plain, wrapped)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("window", [None, 3])
def test_prefill_quant_plain_matches_pallas(kv_dtype, window):
    rs = np.random.RandomState(7)
    B, C, KVH, G, hd, page, bp = 2, 4, 2, 2, 32, 4, 3
    H, NB = KVH * G, B * bp + 1
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _quant_pools(8, NB, page, KVH,
                                                          hd, kv_dtype)
    q = rs.randn(B, C, H, hd).astype(np.float32)
    own_k = rs.randn(B, C, KVH, hd).astype(np.float32)
    own_v = rs.randn(B, C, KVH, hd).astype(np.float32)
    bt = (rs.permutation(NB - 1)[:B * bp] + 1).reshape(B, bp) \
        .astype(np.int32)
    starts, nvalid = np.array([5, 0], np.int32), np.array([4, 2], np.int32)
    scale = 1.0 / np.sqrt(hd)
    want = j_paged.paged_attention_prefill(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(starts),
        jnp.asarray(nvalid), jnp.asarray(own_k), jnp.asarray(own_v),
        scale=scale, window=window, interpret=True, k_scale=jks,
        v_scale=jvs)
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
             torch.from_numpy(starts), torch.from_numpy(nvalid),
             torch.from_numpy(own_k), torch.from_numpy(own_v))
    plain = t_paged.paged_attention_prefill_plain(*targs, scale, window,
                                                  tks, tvs)
    wrapped = ops.paged_attention_prefill(*targs, scale=scale, window=window,
                                          k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **EXACT)
    assert torch.equal(plain, wrapped)


def test_cache_carries_scales_through_prefill_and_cow():
    """init_decode_cache adds unit scales; the one-shot prefill write
    stores the bytes and scales the JAX package's does; the copy-on-write
    block copy moves a block's scales with its codes."""
    jc, tc = j_registry.serving_config(), t_registry.serving_config()
    jcache = j_model.init_decode_cache(jc, 2, 32, num_blocks=6,
                                       kv_dtype="int8")
    tcache = t_model.init_decode_cache(tc, 2, 32, num_blocks=6,
                                       kv_dtype="int8", device="cpu")
    assert set(tcache) == set(jcache)
    L_, S = len(tc.attention_layer_ids()), 20
    kvs = [_values(9 + i, (L_, 2, S, tc.num_kv_heads, tc.head_dim))
           for i in range(2)]
    lens = np.array([S, 11], np.int32)
    jcache = j_model.write_prefill_kv(jc, jcache, tuple(map(jnp.asarray,
                                                            kvs)),
                                      jnp.asarray(lens))
    t_model.write_prefill_kv(tc, tcache, tuple(map(torch.from_numpy, kvs)),
                             torch.from_numpy(lens))
    jcache = j_model.copy_kv_block(jc, jcache, 1, 5)
    t_model.copy_kv_block(tc, tcache, 1, 5)
    for key in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(_bytes(tcache[key]),
                                      _bytes(jcache[key]))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]))
    assert torch.equal(tcache["k_scale"][:, 5], tcache["k_scale"][:, 1])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    return make_setup("f32")


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_serve_matches_jax(setup, kv_dtype):
    """Greedy STEP over a tight quantized pool, chunked prefill: the same
    tokens, statuses and prunes as the JAX engine's dense path."""
    kw = engine_kw(setup, kv_dtype=kv_dtype, prefill_chunk_size=4,
                   decode_horizon=2)
    _, jres = serve_jax(setup, "step", setup["prompts"][:2], 4, **kw)
    eng, tres = serve_torch(setup, "step", setup["prompts"][:2], 4, **kw)
    assert eng.kv_block_bytes == t_kvq.pool_block_bytes(setup["cfg"],
                                                        kv_dtype)
    assert_same_results(jres, tres)
    assert sum(r.num_pruned for r in jres) > 0


def test_int8_kernel_path_equals_dense(setup):
    """Inside the port: the kernel wrappers (the plain K1c on the CPU)
    give the dense path's tokens, statuses and scores over an int8 pool,
    one-shot and chunked prefill."""
    for chunk in (None, 4):
        runs = []
        for use_kernel in (False, True):
            kw = engine_kw(setup, kv_dtype="int8", use_kernel=use_kernel,
                           prefill_chunk_size=chunk, decode_horizon=2)
            _, res = serve_torch(setup, "step", setup["prompts"][:2], 4,
                                 **kw)
            runs.append(res)
        assert_same_results(runs[0], runs[1], tol=1e-6)


def test_quantized_prefix_cache_hit_matches_jax(setup):
    """The scenario of tests/test_kv_quant.py::
    test_prefix_cache_serves_quantized_blocks, held per serve: the cold
    serve to JAX's cold serve, the warm serve (a prefix-cache hit on
    parked int8 blocks) to JAX's warm serve."""
    tok = get_tokenizer()
    prompt = tok.encode("1+2-3+4-5+6-7+8=" * 2, add_bos=True)
    kw = engine_kw(setup, kv_dtype="int8", num_blocks=24, max_new=24)
    jeng, jres = serve_jax(setup, "step", [prompt, prompt], 4,
                           waves=[[0], [1]], **kw)
    teng, tres = serve_torch(setup, "step", [prompt, prompt], 4,
                             waves=[[0], [1]], **kw)
    assert teng.prefix_cache.stats.hits > 0
    assert tres[1].metrics.cached_tokens > 0
    assert_same_results(jres, tres)
    teng.prefix_cache.check_integrity()
