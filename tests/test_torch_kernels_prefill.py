"""The port's paged-attention kernel module, chunked-prefill face, against
the JAX package (see tests/test_torch_kernels.py for the decode face, the
scorer and the CUDA leg; the same tolerances hold here)."""
import math

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_prefill as j_paged_prefill)
from repro.models import layers as j_layers  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from torch_parity import BF16, F32, prefill_case, to_np  # noqa: E402


# ---------------------------------------------------------------------------
# chunked-prefill face
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 9])
def test_prefill_plain_vs_oracle_and_pallas(window):
    """Chunk starts mid-page, ragged validity, an empty pooled prefix."""
    jargs, targs = prefill_case(17, 3, 6, 2, 2, 8, 3, starts=[13, 0, 8],
                                 nvalid=[6, 4, 1])
    scale = 1.0 / math.sqrt(32)
    got = pa.paged_attention_prefill_plain(*targs, scale, window)
    want = ref.paged_attention_prefill_ref(*jargs, scale=scale,
                                           window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), **F32)
    kern = j_paged_prefill(*jargs, scale=scale, window=window,
                           interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(kern), **F32)


@pytest.mark.parametrize("window", [None, 9])
def test_prefill_plain_hd80_vs_oracle_and_pallas(window):
    """zamba2's head dim, as above."""
    jargs, targs = prefill_case(18, 3, 6, 2, 2, 8, 3, starts=[13, 0, 8],
                                nvalid=[6, 4, 1], hd=80)
    scale = 1.0 / math.sqrt(80)
    got = pa.paged_attention_prefill_plain(*targs, scale, window)
    want = ref.paged_attention_prefill_ref(*jargs, scale=scale,
                                           window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), **F32)
    kern = j_paged_prefill(*jargs, scale=scale, window=window,
                           interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(kern), **F32)


@pytest.mark.parametrize("seed", range(8))
def test_prefill_ragged_property(seed):
    """Random chunk starts (mid-page boundaries), ragged num_valid
    (fully padded rows included), sliding windows, G in {1, 4}."""
    rs = np.random.RandomState(1000 + seed)
    B, C, KVH, G = rs.randint(1, 3), (3, 4, 8)[seed % 3], 1 + seed % 2, \
        (1, 4)[seed // 4]
    page, bp = 8, rs.randint(1, 4)
    window = (None, 5)[seed % 2]
    starts = rs.randint(0, page * bp, B)
    nvalid = rs.randint(0, C + 1, B)
    jargs, targs = prefill_case(seed, B, C, KVH, G, page, bp, starts,
                                 nvalid)
    scale = 1.0 / math.sqrt(32)
    got = ops.paged_attention_prefill(*targs, scale=scale, window=window)
    want = ref.paged_attention_prefill_ref(*jargs, scale=scale,
                                           window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), **F32)
    # padded queries emit zeros
    for b in range(B):
        assert torch.all(got[b, nvalid[b]:] == 0.0)


def test_prefill_plain_bf16():
    jargs, targs = prefill_case(5, 2, 8, 2, 4, 16, 3, starts=[21, 0],
                                 nvalid=[8, 5], dt="bf16")
    got = pa.paged_attention_prefill_plain(*targs, 0.2, 16)
    want = ref.paged_attention_prefill_ref(
        *[a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
          for a in jargs], scale=0.2, window=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), **BF16)


def test_wrapper_reshapes_agree_with_plain():
    """The CUDA kernel's query rows: row r of kv head h's tile is chunk
    token r // G, query head h*G + r % G, read and written in place in
    the [B, C, H, hd] layout. Checked by computing the tile row by row
    the way the kernel does; at decode (C = 1) the rows of a kv head are
    its G heads of q [B, H, hd]."""
    B, C, KVH, G, page, bp = 2, 5, 2, 4, 8, 3
    jargs, targs = prefill_case(9, B, C, KVH, G, page, bp, starts=[11, 3],
                                 nvalid=[5, 2])
    q, kp, vp, bt, pl, nv, ok, ov = targs
    kc, vc = pa.gather_pages(kp, bt), pa.gather_pages(vp, bt)
    got = torch.zeros_like(q)
    for b in range(B):
        for h in range(KVH):
            for r in range(C * G):
                c, head = r // G, h * G + r % G   # the kernel's row map
                keys = torch.cat([kc[b, :pl[b], h], ok[b, :c + 1, h]])
                vals = torch.cat([vc[b, :pl[b], h], ov[b, :c + 1, h]])
                if c >= nv[b]:
                    continue   # padded query: zeros
                p = torch.softmax(keys @ q[b, c, head] * 0.3, dim=0)
                got[b, c, head] = p @ vals
    want = pa.paged_attention_prefill_plain(q, kp, vp, bt, pl, nv, ok, ov,
                                            0.3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # decode: C = 1, row r of kv head h is query head h*G + r
    qd = q[:, 0].contiguous()
    rows = qd[:, None].reshape(B, 1, KVH, G, 32)
    for h in range(KVH):
        for r in range(G):
            assert torch.equal(rows[:, 0, h, r], qd[:, h * G + r])


def test_prefill_chunk_layer_matches_jax():
    """The chunk-prefill layer (KV scatter + attention + wo), both paths of
    the port against the JAX layer, chunk boundary mid-page."""
    jcfg, cfg = j_serving_config(), serving_config()
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           j_init_params(jcfg, jax.random.PRNGKey(0)))
    jlp = jax.tree.map(lambda x: x[0], jparams["layers"])["attn"]
    tlp = {k: v[0] for k, v in params_from_numpy(
        jax.device_get(jparams), device="cpu")["layers"]["attn"].items()}
    B, C, cap, bs = 1, 5, 64, cfg.kv_block_size
    bp = cap // bs
    rs = np.random.RandomState(2)
    x = 0.1 * rs.randn(B, C, cfg.d_model).astype(np.float32)
    positions = (bs + 3 + np.arange(C, dtype=np.int32))[None, :]
    valid = np.arange(C)[None, :] < 4
    pools = [0.5 * rs.randn(bp + 1, bs, cfg.num_kv_heads,
                            cfg.head_dim).astype(np.float32)
             for _ in range(2)]
    bt = np.arange(1, bp + 1, dtype=np.int32)[None, :]
    out_j, nk_j, nv_j = j_layers.gqa_attention_prefill_chunk(
        jlp, jcfg, jnp.asarray(x), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(bt), cap)
    for uk in (False, True):
        kp, vp = (torch.from_numpy(p.copy()) for p in pools)
        out = t_layers.gqa_attention_prefill_chunk(
            tlp, cfg, torch.from_numpy(x), torch.from_numpy(positions),
            torch.from_numpy(valid), kp, vp, torch.from_numpy(bt), cap,
            use_kernel=uk)
        np.testing.assert_allclose(to_np(out)[:, :4], to_np(out_j)[:, :4],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(to_np(kp), to_np(nk_j), **F32)
        np.testing.assert_allclose(to_np(vp), to_np(nv_j), **F32)
