"""The port's seamless-m4t-large-v2 (encoder-decoder over stub frontend
embeddings) against the JAX package at its serving config: configs and
params, ``encode`` (causal, as the reference's), ``cross_kv`` /
``cross_attention``, ``forward_full(encoder_embeds=)``, ``decode_step``
over the cross caches and ``lm_loss``, with the kernel wrappers' plain
versions beside the dense path; and the engine's refusal, where the JAX
engine fails at prefill.

Tolerances: f32 params at 1e-4, as ``tests/test_torch_model.py``.
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
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro.serving.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.core.pruning import make_policy as j_make_policy  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.init import init_params, padded_vocab  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from torch_parity import to_np  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-4, atol=1e-4)
CAP = 64


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def setup():
    """The serving config (smoke widths, the task tokenizer's vocab) in
    both packages on the same f32 weights, and frame embeddings of the
    config's 32 encoder positions for two sequences."""
    jcfg = j_registry.serving_config(ARCH)
    cfg = t_registry.serving_config(ARCH)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      j_init_params(jcfg, jax.random.PRNGKey(0)))
    enc = (0.5 * np.random.RandomState(7).randn(
        2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return {"jcfg": jcfg, "cfg": cfg, "jp": jp,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "enc": enc}


def _tokens(B, S, seed, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _enc(s):
    return jnp.asarray(s["enc"]), torch.from_numpy(s["enc"])


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_and_params_match_jax(setup):
    """full_config() and smoke_config() equal the JAX package's field by
    field; the port's init has the bridged tree's names and shapes: an
    ``encoder`` stack (ln1, attn, ln2, mlp), ``encoder_norm``, and decoder
    layers with ``ln_cross`` and a GQA ``cross`` attention."""
    for smoke in (False, True):
        assert t_registry.get_config(ARCH, smoke).__dict__ == \
            j_registry.get_config(ARCH, smoke).__dict__
    full = t_registry.get_config(ARCH)
    assert (full.is_encoder_decoder, full.num_layers,
            full.num_encoder_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.d_ff,
            padded_vocab(full), full.encoder_seq_len) == \
        (True, 24, 24, 1024, 16, 16, 64, 8192, 256256, 1024)
    cfg, tp = setup["cfg"], setup["tp"]
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in _leaves(tp)}
    Le, L, D = cfg.num_encoder_layers, cfg.num_layers, cfg.d_model
    hd = cfg.num_heads * cfg.head_dim
    assert set(tp["encoder"]) == {"ln1", "attn", "ln2", "mlp"}
    assert tuple(tp["encoder"]["attn"]["wq"].shape) == (Le, D, hd)
    assert tuple(tp["encoder_norm"].shape) == (D,)
    assert {"ln_cross", "cross"} <= set(tp["layers"])
    assert {k: tuple(v.shape) for k, v in tp["layers"]["cross"].items()} \
        == {"wq": (L, D, hd), "wk": (L, D, hd), "wv": (L, D, hd),
            "wo": (L, hd, D)}


# ---------------------------------------------------------------------------
# encoder and cross-attention
# ---------------------------------------------------------------------------

def test_encode_is_causal_and_matches_jax(setup):
    """``encode`` at 1e-4. Its attention is causal, as the reference's
    (``gqa_attention_full(window=None)``, ROADMAP C): changing the last
    frame leaves every earlier position's output as it was, in both
    packages."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    je_, te_ = _enc(setup)
    jo = jm.encode(jp, jcfg, je_)
    to = tm.encode(tp, cfg, te_)
    np.testing.assert_allclose(to_np(to), to_np(jo), **TOL)
    moved = setup["enc"].copy()
    moved[:, -1] += 1.0
    jo2 = jm.encode(jp, jcfg, jnp.asarray(moved))
    to2 = tm.encode(tp, cfg, torch.from_numpy(moved))
    for a, b in ((to_np(to), to_np(to2)), (to_np(jo), to_np(jo2))):
        np.testing.assert_array_equal(a[:, :-1], b[:, :-1])
        assert np.abs(a[:, -1] - b[:, -1]).max() > 1e-3


def test_cross_kv_and_cross_attention_match_jax(setup):
    """One decoder layer's ``cross_kv`` of the encoder output and its
    ``cross_attention`` (unmasked, no rope) at 1e-4, over 5 query
    positions; with f32 queries over the JAX package's bf16 cross cache
    as well."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp = jax.tree.map(lambda x: x[0], setup["jp"]["layers"]["cross"])
    tp = tm._index(setup["tp"]["layers"]["cross"], 0)
    je_, te_ = _enc(setup)
    jk, jv = jl.cross_kv(jp, jcfg, je_)
    tk, tv = tl.cross_kv(tp, cfg, te_)
    np.testing.assert_allclose(to_np(tk), to_np(jk), **TOL)
    np.testing.assert_allclose(to_np(tv), to_np(jv), **TOL)
    x = np.random.RandomState(3).randn(2, 5, cfg.d_model).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jo = jl.cross_attention(jp, jcfg, jnp.asarray(x), jk.astype(jdt),
                                jv.astype(jdt))
        kv = (torch.from_numpy(np.array(to_np(t.astype(jdt)))).to(tdt)
              for t in (jk, jv))
        to = tl.cross_attention(tp, cfg, torch.from_numpy(x), *kv)
        np.testing.assert_allclose(to_np(to), to_np(jo), **TOL)


# ---------------------------------------------------------------------------
# the model's functions
# ---------------------------------------------------------------------------

def test_forward_full_matches_jax(setup):
    """The decoder over 20 tokens with the encoder's output: logits and
    hidden states at 1e-4, dense and through the flash wrapper (its plain
    version here); the encoder stays dense under ``use_kernel`` as in the
    JAX package. Without encoder embeddings the port raises (the JAX
    forward asserts)."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    je_, te_ = _enc(setup)
    toks = _tokens(2, 20, 0, cfg.vocab_size)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks), encoder_embeds=je_)
    outs = []
    for use_kernel in (False, True):
        to = tm.forward_full(tp, cfg, torch.from_numpy(toks),
                             encoder_embeds=te_, use_kernel=use_kernel)
        for key in ("logits", "hidden"):
            np.testing.assert_allclose(to_np(to[key]), to_np(jo[key]), **TOL)
        assert float(to["aux_loss"]) == 0.0
        outs.append(to["logits"])
    torch.testing.assert_close(outs[1], outs[0], **TOL)
    with pytest.raises(ValueError, match="encoder_embeds"):
        tm.forward_full(tp, cfg, torch.from_numpy(toks))


def _decode_case(s, B, S, extra, seed):
    """A prefill of ``S`` decoder tokens written into fresh pools of both
    packages, each cache's cross entries from ``build_cross_cache``."""
    jcfg, cfg, jp, tp = s["jcfg"], s["cfg"], s["jp"], s["tp"]
    je_, te_ = _enc(s)
    toks = _tokens(B, S + extra, seed, cfg.vocab_size)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks[:, :S]),
                         encoder_embeds=je_, return_kv=True)
    to = tm.forward_full(tp, cfg, torch.from_numpy(toks[:, :S]),
                         encoder_embeds=te_, return_kv=True)
    jc = jm.write_prefill_kv(jcfg, jm.init_decode_cache(
        jcfg, B, CAP, kv_dtype="f32"), jo["kvs"], jnp.full((B,), S,
                                                          jnp.int32))
    tc = tm.write_prefill_kv(cfg, tm.init_decode_cache(
        cfg, B, CAP, kv_dtype="f32", device="cpu"), to["kvs"],
        torch.full((B,), S, dtype=torch.int32))
    jc["cross_k"], jc["cross_v"] = jm.build_cross_cache(
        jp, jcfg, jm.encode(jp, jcfg, je_))
    tc["cross_k"], tc["cross_v"] = tm.build_cross_cache(
        tp, cfg, tm.encode(tp, cfg, te_))
    return toks, jc, tc


def test_decode_steps_match_jax(setup):
    """Three decode steps after a 16-token prefill over the cross caches,
    dense and kernel wrappers in turn: logits, hidden states and the
    pools at 1e-4; the last step's logits equal the full forward's at the
    same position within 1e-4. The cross caches are read, not written."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    B, S = 2, 16
    toks, jc, tc = _decode_case(setup, B, S, 3, 1)
    assert tuple(tc["cross_k"].shape) == (cfg.num_layers, B,
                                          cfg.encoder_seq_len,
                                          cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(to_np(tc["cross_v"]), to_np(jc["cross_v"]),
                               **TOL)
    cross = tc["cross_k"].clone()
    for i in range(3):
        nt, pos = toks[:, S + i:S + i + 1], np.full((B,), S + i, np.int32)
        jd = jm.decode_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                            window_len=CAP)
        td = tm.decode_step(tp, cfg, torch.from_numpy(nt),
                            torch.from_numpy(pos), tc, window_len=CAP,
                            use_kernel=bool(i % 2))
        jc, tc = jd["cache"], td["cache"]
        np.testing.assert_allclose(to_np(td["logits"]), to_np(jd["logits"]),
                                   **TOL)
        np.testing.assert_allclose(to_np(td["hidden"]), to_np(jd["hidden"]),
                                   **TOL)
    for k in ("k_pool", "v_pool"):
        np.testing.assert_allclose(to_np(tc[k]), to_np(jc[k]), **TOL)
    torch.testing.assert_close(tc["cross_k"], cross, rtol=0, atol=0)
    full = tm.forward_full(tp, cfg, torch.from_numpy(toks),
                           encoder_embeds=_enc(setup)[1])
    np.testing.assert_allclose(to_np(td["logits"]),
                               to_np(full["logits"][:, -1]), **TOL)


def test_decode_kernel_path_plain_equals_dense(setup):
    """Four decode steps through the paged-attention wrapper's plain
    version (K1a on the card) against the dense decode, from one prefill:
    logits within 1e-5 at every step."""
    cfg, tp = setup["cfg"], setup["tp"]
    B, S = 2, 12
    toks, _, tc = _decode_case(setup, B, S, 4, 2)
    caches = {k: {key: v.clone() for key, v in tc.items()}
              for k in (False, True)}
    for i in range(4):
        nt = torch.from_numpy(toks[:, S + i:S + i + 1])
        pos = torch.full((B,), S + i, dtype=torch.int32)
        outs = {k: tm.decode_step(tp, cfg, nt, pos, caches[k],
                                  window_len=CAP, use_kernel=k)["logits"]
                for k in (False, True)}
        torch.testing.assert_close(outs[True], outs[False], rtol=1e-5,
                                   atol=1e-5)


def test_lm_loss_matches_jax(setup):
    """``lm_loss(encoder_embeds=)`` equals the JAX one (no MoE: no aux
    term)."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    je_, te_ = _enc(setup)
    toks = _tokens(2, 20, 4, cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    labels[1, -4:] = -1
    want = jm.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                      encoder_embeds=je_)
    with torch.no_grad():
        got = tm.lm_loss(tp, cfg, torch.from_numpy(toks),
                         torch.from_numpy(labels), encoder_embeds=te_)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_decode_cache_matches_jax(setup):
    """``init_decode_cache`` adds zeroed bf16 cross entries [L, B, T,
    KVH, hd]: T = ``encoder_len``, else the config's ``encoder_seq_len``,
    as in the JAX package."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    for enc_len in (None, 48):
        jc = jm.init_decode_cache(jcfg, 3, CAP, encoder_len=enc_len)
        tc = tm.init_decode_cache(cfg, 3, CAP, encoder_len=enc_len,
                                  device="cpu")
        assert set(tc) == set(jc)
        for k in tc:
            assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert tc["cross_k"].dtype == torch.bfloat16
        assert not tc["cross_v"].any()


def test_engine_refuses_where_jax_fails_at_prefill(setup):
    """No engine path of the JAX package feeds encoder embeddings: its
    engine builds, and its first prefill fails on ``forward_full``'s
    assert. The port's engine refuses the config at construction."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    sp = JSamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                         max_new_tokens=4)
    eng = je.Engine(setup["jp"], jcfg,
                    je.EngineConfig(max_batch=4, num_blocks=16, capacity=64,
                                    max_new_tokens=4, sampling=sp,
                                    use_kernel=False, faults=None),
                    j_make_policy("sc"))
    with pytest.raises(AssertionError):
        eng.serve([1, 5, 6, 7], 2)
    with pytest.raises(NotImplementedError, match="encoder"):
        te.Engine(setup["tp"], cfg, te.EngineConfig(faults=None),
                  make_policy("sc"), device="cpu")
    assert not tm.supports_chunked_prefill(cfg)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tm.prefill_chunk_step(setup["tp"], cfg,
                              torch.zeros((1, 4), dtype=torch.int32),
                              torch.zeros((1, 4), dtype=torch.int32),
                              torch.ones((1, 4), dtype=torch.bool), {}, 64)
