"""The port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those plain versions to the ``repro/kernels/ref.py`` oracles and to the
Pallas kernels in interpret mode, over the ranges ``tests/test_kernels.py``
covers. The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py holds each against its plain version there.

Tolerances: f32 at 1e-5 relative / 1e-6 absolute (summation order only).
bf16 inputs at 2e-2: the oracles round the softmax probabilities to bf16
before the P.V product and the port's output is rounded to bf16, each
worth up to one bf16 ulp (2^-8 relative).
"""
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
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.core.scorer import scorer_score as j_scorer_score  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_prefill as j_paged_prefill)
from repro.kernels.step_score import step_score as j_step_score  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.scorer import scorer_score  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import step_score as ss  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from torch_parity import (BF16, F32, decode_case, pair, prefill_case,  # noqa: E402
                          to_np)

# ---------------------------------------------------------------------------
# decode face
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KVH,hd,page,bp", [
    (1, 4, 1, 64, 16, 3),     # MQA
    (3, 8, 2, 64, 16, 4),     # GQA
    (2, 4, 4, 128, 32, 2),    # MHA
    (2, 16, 8, 64, 64, 5),
    (3, 8, 2, 32, 16, 3),     # zamba2's smoke head dim
    (2, 4, 4, 80, 16, 3),     # zamba2's head dim, MHA
    (2, 48, 1, 128, 16, 2),   # granite-20b's 48 query heads over 1
])
def test_decode_plain_vs_oracle_and_pallas(B, H, KVH, hd, page, bp, dt):
    jargs, targs = decode_case(0, B, H, KVH, hd, page, bp, dt=dt)
    scale = 1.0 / math.sqrt(hd)
    got = pa.paged_attention_plain(*targs, scale)
    assert got.dtype == targs[0].dtype and got.shape == (B, H, hd)
    tol = F32 if dt == "f32" else BF16
    want = ref.paged_attention_ref(*[a.astype(jnp.float32) if i < 3 else a
                                     for i, a in enumerate(jargs)],
                                   scale=scale)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)
    if dt == "f32":  # the interpret-mode Pallas kernel
        kern = j_paged(*jargs, scale=scale, interpret=True)
        np.testing.assert_allclose(to_np(got), to_np(kern), **F32)


@pytest.mark.parametrize("seed", range(6))
def test_decode_ragged_groups_and_full_window(seed):
    """Ragged cache_lens including empty and exactly-full rows (the
    rolling-window wraparound fills every slot), G in {1, 2, 4}."""
    rs = np.random.RandomState(100 + seed)
    B, KVH, G = rs.randint(1, 4), (1, 2, 4)[seed % 3], (1, 2, 4)[seed // 2]
    page, bp = (8, 16)[seed % 2], rs.randint(1, 5)
    lens = rs.randint(0, page * bp + 1, B)
    lens[0] = (0, page * bp)[seed % 2]
    jargs, targs = decode_case(seed, B, KVH * G, KVH, 32, page, bp, lens)
    got = pa.paged_attention_plain(*targs, 0.2)
    dense = j_layers.paged_attention_decode(jargs[1], jargs[2], jargs[0],
                                            jargs[3], jargs[4], scale=0.2)
    np.testing.assert_allclose(to_np(got), to_np(dense), **F32)
    kern = j_paged(*jargs, scale=0.2, interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(kern), **F32)


def test_decode_empty_cache_emits_zeros():
    jargs, targs = decode_case(3, 2, 4, 2, 32, 16, 2, lens=[0, 7])
    got = ops.paged_attention(*targs, scale=0.2)   # wrapper, CPU -> plain
    want = ref.paged_attention_ref(*jargs, scale=0.2)
    assert torch.all(got[0] == 0.0)
    assert torch.any(got[1] != 0.0)
    np.testing.assert_allclose(to_np(got), to_np(want), **F32)


def test_decode_layer_after_wraparound_matches_jax():
    """The whole decode layer at positions past the window (slot =
    pos % window_len wraps into low blocks), both paths of the port
    against both paths of the JAX package."""
    jcfg, cfg = j_serving_config(), serving_config()
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           j_init_params(jcfg, jax.random.PRNGKey(0)))
    jlp = jax.tree.map(lambda x: x[0], jparams["layers"])["attn"]
    tlp = {k: v[0] for k, v in params_from_numpy(
        jax.device_get(jparams), device="cpu")["layers"]["attn"].items()}
    B, window_len, bs = 2, 32, cfg.kv_block_size
    bp = window_len // bs
    rs = np.random.RandomState(1)
    x = 0.1 * rs.randn(B, 1, cfg.d_model).astype(np.float32)
    positions = np.array([window_len + 5, window_len * 2 + 1], np.int32)
    pools = {n: rs.randn(B * bp + 1, bs, cfg.num_kv_heads,
                         cfg.head_dim).astype(np.float32)
             for n in ("k_pool", "v_pool")}
    bt = np.arange(1, B * bp + 1, dtype=np.int32).reshape(B, bp)
    jout = {}
    for uk in (False, True):
        cache = {**{k: jnp.asarray(v) for k, v in pools.items()},
                 "block_tables": jnp.asarray(bt), "window_len": window_len,
                 "use_kernel": uk}
        out, (nk, nv) = j_layers.gqa_attention_decode(
            jlp, jcfg, jnp.asarray(x), jnp.asarray(positions), cache, 0)
        jout[uk] = (to_np(out), to_np(nk), to_np(nv))
    for uk in (False, True):
        tp = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
        out = t_layers.gqa_attention_decode(
            tlp, cfg, torch.from_numpy(x), torch.from_numpy(positions),
            {**tp, "block_tables": torch.from_numpy(bt),
             "window_len": window_len, "use_kernel": uk})
        np.testing.assert_allclose(to_np(out), jout[uk][0], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(to_np(tp["k_pool"]), jout[uk][1], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(to_np(tp["v_pool"]), jout[uk][2], rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# step scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,D", [(1, 64), (8, 256), (130, 512), (64, 2560)])
def test_step_score_plain_vs_oracle_and_pallas(B, D):
    rs = np.random.RandomState(B + D)
    h = rs.randn(B, D).astype(np.float32)
    w = [rs.randn(D, 512) * 0.05, rs.randn(512) * 0.1,
         rs.randn(512, 1) * 0.05, rs.randn(1) * 0.1]
    w = [a.astype(np.float32) for a in w]
    got = ss.step_score_plain(torch.from_numpy(h),
                              *[torch.from_numpy(a) for a in w])
    want = ref.step_score_ref(jnp.asarray(h), *[jnp.asarray(a) for a in w])
    np.testing.assert_allclose(to_np(got), to_np(want), **F32)
    kern = j_step_score(jnp.asarray(h), *[jnp.asarray(a) for a in w],
                        blk_b=64, interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(kern), **F32)


def test_step_score_matches_scorer_module():
    """Wrapper (CPU -> plain) == core.scorer.scorer_score, both packages,
    on a bf16 hidden (cast to f32 inside, as the fused kernel does)."""
    jp = j_init_scorer(jax.random.PRNGKey(1), 128)
    tp = scorer_from_numpy(jax.device_get(jp), device="cpu")
    h = np.random.RandomState(2).randn(16, 128).astype(np.float32)
    jh, th = pair(h, "bf16")
    got = ops.step_score_params(th, tp)
    np.testing.assert_allclose(to_np(got), to_np(scorer_score(tp, th)), **F32)
    np.testing.assert_allclose(to_np(got), to_np(j_scorer_score(jp, jh)), **F32)


# ---------------------------------------------------------------------------
# launch counts (the CUDA kernels themselves: tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

def test_cpu_wrappers_count_no_launch():
    ops.reset_launch_counts()
    _, targs = decode_case(0, 2, 4, 2, 64, 16, 2)
    ops.paged_attention(*targs, scale=0.1)
    assert ops.launch_counts() == {"paged_attention_decode": 0,
                                   "paged_attention_prefill": 0,
                                   "paged_attention_decode_quant": 0,
                                   "paged_attention_prefill_quant": 0,
                                   "step_score": 0, "flash_attention": 0,
                                   "ssd_scan": 0, "ssm_decode": 0,
                                   "decode_graph_replays": 0,
                                   "decode_graph_captures": 0}
