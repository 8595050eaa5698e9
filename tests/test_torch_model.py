"""The port's dense stack against the JAX package at ``serving_config()``:
the weight bridge, ``forward_full``, ``decode_step``,
``multi_decode_step`` (K = 1 and K = 4) and ``prefill_chunk_step``, on
the same weights and inputs.

Tolerances: f32 params at 1e-4 (the two frameworks sum matmuls, softmax
and norms in other orders). bf16 params at 5e-2 on the logits and at
3e-2 absolute plus 3e-2 relative on hidden states and K/V: every matmul
and residual add rounds its output to bf16 (2^-8 relative), so where the
two frameworks round one activation to neighbouring bf16 values the
difference carries through the later layers, a few ulps by the end.
Greedy tokens must be identical.
"""
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
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving.sampling import sample_logits as j_sample  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.scorer import scorer_score  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.models.init import init_params, padded_vocab  # noqa: E402
from repro_torch.serving.sampling import sample_logits as t_sample  # noqa: E402
from torch_parity import to_np  # noqa: E402

TOL = {"f32": dict(rtol=1e-4, atol=1e-4),
       "bf16": dict(rtol=0, atol=5e-2)}
HIDDEN_TOL = {"f32": dict(rtol=1e-4, atol=1e-4),
              "bf16": dict(rtol=3e-2, atol=3e-2)}
CAP, BS = 64, 16


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = j_serving_config(), serving_config()
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    out = {}
    for dt in ("f32", "bf16"):
        p = jp if dt == "bf16" else jax.tree.map(
            lambda x: x.astype(jnp.float32), jp)
        out[dt] = (p, params_from_numpy(jax.device_get(p), device="cpu"))
    return jcfg, cfg, out, (js, scorer_from_numpy(jax.device_get(js), device="cpu"))


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 25, (B, S)).astype(np.int32)


def test_bridge_is_one_to_one(models):
    jcfg, cfg, params, _ = models
    jp, tp = params["bf16"]
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(to_np(t), to_np(leaf))
    assert tp["embed"].shape[0] == padded_vocab(cfg) == 256
    # the port's own init has the same names, shapes and dtypes
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in _leaves(tp)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_full_matches(models, dt):
    jcfg, cfg, params, _ = models
    jp, tp = params[dt]
    toks = _tokens(2, 12)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks), return_kv=True)
    to = tm.forward_full(tp, cfg, torch.from_numpy(toks), return_kv=True)
    np.testing.assert_allclose(to_np(to["logits"]), to_np(jo["logits"]),
                               **TOL[dt])
    np.testing.assert_allclose(to_np(to["hidden"]), to_np(jo["hidden"]),
                               **HIDDEN_TOL[dt])
    for a, b in zip(to["kvs"], jo["kvs"]):
        np.testing.assert_allclose(to_np(a), to_np(b), **HIDDEN_TOL[dt])
    V = cfg.vocab_size
    assert np.array_equal(to_np(to["logits"])[..., :V].argmax(-1),
                          to_np(jo["logits"])[..., :V].argmax(-1))


def _pools(cfg, nb, dt, seed=1):
    rs = np.random.RandomState(seed)
    shape = (cfg.num_layers, nb, BS, cfg.num_kv_heads, cfg.head_dim)
    return [0.5 * rs.randn(*shape).astype(np.float32) for _ in range(2)]


def _caches(cfg, pools, bt, dt):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jc = {"k_pool": jnp.asarray(pools[0], jd),
          "v_pool": jnp.asarray(pools[1], jd), "block_tables": jnp.asarray(bt)}
    tc = {"k_pool": torch.from_numpy(pools[0]).to(td),
          "v_pool": torch.from_numpy(pools[1]).to(td),
          "block_tables": torch.from_numpy(bt)}
    return jc, tc


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_step_matches(models, dt, use_kernel):
    jcfg, cfg, params, _ = models
    jp, tp = params[dt]
    B, bp = 3, CAP // BS
    bt = np.arange(1, B * bp + 1, dtype=np.int32).reshape(B, bp)
    jc, tc = _caches(cfg, _pools(cfg, B * bp + 1, dt), bt, dt)
    toks = _tokens(B, 1, seed=2)
    pos = np.array([5, 17, CAP + 3], np.int32)   # the last one wraps
    jo = jm.decode_step(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc,
                        window_len=CAP, use_kernel=use_kernel)
    to = tm.decode_step(tp, cfg, torch.from_numpy(toks),
                        torch.from_numpy(pos), tc, window_len=CAP,
                        use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(to["logits"]), to_np(jo["logits"]),
                               **TOL[dt])
    np.testing.assert_allclose(to_np(to["hidden"]), to_np(jo["hidden"]),
                               **HIDDEN_TOL[dt])
    for key in ("k_pool", "v_pool"):   # written in place by the port
        np.testing.assert_allclose(to_np(tc[key]), to_np(jo["cache"][key]),
                                   **HIDDEN_TOL[dt])


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_multi_decode_step_matches(models, dt, horizon):
    """Greedy horizon: identical tokens, validity and score masks; lanes
    freeze on EOS or their limit and dead lanes write only scratch."""
    jcfg, cfg, params, scorers = models
    jp, tp = params[dt]
    js, ts = scorers
    B, bp = 4, CAP // BS
    bt = np.arange(1, B * bp + 1, dtype=np.int32).reshape(B, bp)
    jc, tc = _caches(cfg, _pools(cfg, B * bp + 1, dt, seed=3), bt, dt)
    toks = np.array([5, 7, 11, 5], np.int32)   # 5 is the step token
    pos = np.array([9, 30, 2, 40], np.int32)
    limits = np.array([horizon, max(horizon - 2, 1), 0, horizon], np.int32)
    V = cfg.vocab_size

    def j_sample_fn(key, logits):
        return j_sample(key, logits.at[:, V:].set(-jnp.inf), temperature=0.0)

    def t_sample_fn(rng, logits):
        logits[:, V:] = -torch.inf
        return t_sample(rng, logits, temperature=0.0)

    jo = jm.multi_decode_step(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(limits),
        jc, window_len=CAP, horizon=horizon,
        rng_keys=jax.random.split(jax.random.PRNGKey(0), horizon),
        sample_fn=j_sample_fn, eos_id=2, step_id=5,
        score_fn=lambda h: j_scorer_score(js, h), scratch_block=0)
    to = tm.multi_decode_step(
        tp, cfg, torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(limits), tc, window_len=CAP, horizon=horizon,
        rng=None, sample_fn=t_sample_fn, eos_id=2, step_id=5,
        score_fn=lambda h: scorer_score(ts, h), scratch_block=0)
    for key in ("tokens", "token_valid", "score_valid", "final_tokens",
                "positions"):
        np.testing.assert_array_equal(to[key].numpy(), np.asarray(jo[key]),
                                      err_msg=key)
    assert to["tokens"].shape == (B, horizon)
    valid = np.asarray(jo["token_valid"])
    np.testing.assert_allclose(to_np(to["confidences"])[valid],
                               to_np(jo["confidences"])[valid], **TOL[dt])
    sv = np.asarray(jo["score_valid"])
    np.testing.assert_allclose(to_np(to["scores"])[sv],
                               to_np(jo["scores"])[sv], **TOL[dt])
    for key in ("k_pool", "v_pool"):
        # block 0 is scratch: frozen lanes race on it, never read unmasked
        np.testing.assert_allclose(to_np(to["cache"][key])[:, 1:],
                                   to_np(jo["cache"][key])[:, 1:],
                                   **HIDDEN_TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_chunk_step_matches(models, dt):
    """A second chunk (start 8, 5 of 8 slots valid) over a first chunk's
    pooled prefix, both paths of the port against the JAX dense path."""
    jcfg, cfg, params, _ = models
    jp, tp = params[dt]
    bp = CAP // BS
    bt = np.arange(1, bp + 1, dtype=np.int32)[None, :]
    C = 8
    toks = _tokens(1, C, seed=4)
    pos = (8 + np.arange(C, dtype=np.int32))[None, :]
    valid = np.arange(C)[None, :] < 5
    outs = {}
    for uk in (False, True):
        jc, tc = _caches(cfg, _pools(cfg, bp + 1, dt, seed=5), bt, dt)
        jo = jm.prefill_chunk_step(jp, jcfg, jnp.asarray(toks),
                                   jnp.asarray(pos), jnp.asarray(valid), jc,
                                   window_len=CAP)
        to = tm.prefill_chunk_step(tp, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(valid), tc,
                                   window_len=CAP, use_kernel=uk)
        np.testing.assert_allclose(to_np(to["logits"])[:, :5],
                                   to_np(jo["logits"])[:, :5], **TOL[dt])
        for key in ("k_pool", "v_pool"):
            np.testing.assert_allclose(to_np(tc[key])[:, 1:],
                                       to_np(jo["cache"][key])[:, 1:],
                                       **HIDDEN_TOL[dt])
        outs[uk] = to["logits"]
    # on the CPU the kernel wrapper runs the plain version: same numbers
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


def test_write_prefill_and_copy_block_match(models):
    jcfg, cfg, params, _ = models
    jp, tp = params["f32"]
    toks = _tokens(1, 21, seed=6)
    jkv = jm.forward_full(jp, jcfg, jnp.asarray(toks), return_kv=True)["kvs"]
    tkv = tm.forward_full(tp, cfg, torch.from_numpy(toks),
                          return_kv=True)["kvs"]
    bt = np.array([[3, 1, 4, 0]], np.int32)
    jc, tc = _caches(cfg, [np.zeros((cfg.num_layers, 6, BS, cfg.num_kv_heads,
                                     cfg.head_dim), np.float32)
                           for _ in range(2)], bt, "f32")
    jc = jm.write_prefill_kv(jcfg, jc, jkv, jnp.asarray([21], jnp.int32))
    tm.write_prefill_kv(cfg, tc, tkv, torch.tensor([21], dtype=torch.int32))
    jc = jm.copy_kv_block(jcfg, jc, 4, 5)
    tm.copy_kv_block(cfg, tc, 4, 5)
    for key in ("k_pool", "v_pool"):
        np.testing.assert_allclose(to_np(tc[key]), to_np(jc[key]),
                                   **HIDDEN_TOL["f32"])
        assert torch.equal(tc[key][:, 5], tc[key][:, 4])
    cache = tm.init_decode_cache(cfg, 2, CAP, num_blocks=9, kv_dtype="f32",
                                 device="cpu")
    jcache = jm.init_decode_cache(jcfg, 2, CAP, num_blocks=9, kv_dtype="f32")
    assert cache["block_tables"].tolist() == \
        np.asarray(jcache["block_tables"]).tolist()
    assert tuple(cache["k_pool"].shape) == jcache["k_pool"].shape


def test_out_of_range_block_index_raises_on_cpu(models):
    """JAX clamps an out-of-range gather; the port checks on the CPU."""
    _, cfg, params, _ = models
    _, tp = params["f32"]
    bt = np.full((1, CAP // BS), 99, np.int32)   # no such block
    _, tc = _caches(cfg, _pools(cfg, 5, "f32"), bt, "f32")
    with pytest.raises(IndexError):
        tm.decode_step(tp, cfg, torch.zeros((1, 1), dtype=torch.int32),
                       torch.tensor([3], dtype=torch.int32), tc,
                       window_len=CAP)


# ---------------------------------------------------------------------------
# sampling: greedy is key-free; a sampled draw matches given the same noise
# ---------------------------------------------------------------------------

def _logits(B=5, V=64, seed=7):
    return np.random.RandomState(seed).randn(B, V).astype(np.float32) * 3


def test_greedy_sampling_matches():
    lg = _logits()
    jt, jc = j_sample(jax.random.PRNGKey(0), jnp.asarray(lg),
                      temperature=0.0)
    tt, tc = t_sample(None, torch.from_numpy(lg), temperature=0.0)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, 20, 0.95), (1.0, 0, 1.0), (0.5, 5, 1.0), (1.3, 0, 0.7)])
def test_sampled_draw_matches_with_shared_noise(temperature, top_k, top_p):
    """``jax.random.categorical`` is argmax(logits + gumbel(key)); feeding
    the port that Gumbel noise reproduces the JAX draw token for token."""
    lg = _logits(B=16)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jt, jc = j_sample(key, jnp.asarray(lg), temperature=temperature,
                          top_k=top_k, top_p=top_p)
        noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, lg.shape)))
        tt, tc = t_sample(None, torch.from_numpy(lg),
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          noise=noise)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)


def test_lanewise_sampling_matches_with_shared_noise():
    from repro.serving.sampling import sample_logits_lanes as j_lanes
    from repro_torch.serving.sampling import sample_logits_lanes as t_lanes
    lg = _logits(B=6)
    temps = np.array([0.0, 0.8, 1.0, 0.5, 1.3, 0.0], np.float32)
    topk = np.array([0, 20, 0, 5, 0, 3], np.int32)
    topp = np.array([1.0, 0.95, 1.0, 1.0, 0.7, 0.5], np.float32)
    key = jax.random.PRNGKey(4)
    jt, jc = j_lanes(key, jnp.asarray(lg), jnp.asarray(temps),
                     jnp.asarray(topk), jnp.asarray(topp))
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, lg.shape)))
    tt, tc = t_lanes(None, torch.from_numpy(lg), torch.from_numpy(temps),
                     torch.from_numpy(topk), torch.from_numpy(topp),
                     noise=noise)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)


def test_sampling_draws_from_the_generator():
    lg = torch.from_numpy(_logits(B=64))
    draws = [t_sample(torch.Generator().manual_seed(s), lg)[0]
             for s in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    # top-k: every draw lies among the 5 largest logits of its row
    tok, _ = t_sample(torch.Generator().manual_seed(2), lg, top_k=5,
                      top_p=1.0)
    top5 = lg.topk(5, dim=-1).indices
    assert bool((top5 == tok[:, None].long()).any(dim=-1).all())
