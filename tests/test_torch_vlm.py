"""The port's internvl2-2b (vlm: the InternLM2 decoder that takes a stub
vision frontend's patch embeddings) against the JAX package at its smoke
config: configs and params (the padded vocab, the untied head),
``forward_full`` with ``modality_embeds``, ``lm_loss``, decode after a
prefill that carries the vision embeddings, and a greedy STEP serve.

The serving engines of both packages serve the vlm as text: nothing in
them passes modality embeddings, so the serve holds the text path.

Tolerances as in ``tests/test_torch_dense_archs.py``: f32 params, logits
and hidden states at 1e-4 (the frameworks sum in other orders); greedy
tokens, statuses and prune counts identical, step scores and confidences
within 1e-4.
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
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.data.arithmetic import make_prompt  # noqa: E402
from repro.data.tokenizer import get_tokenizer  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving.evaluate import make_problems  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.models.init import init_params, padded_vocab  # noqa: E402
from test_torch_engine import assert_same_results, serve_jax, serve_torch  # noqa: E402
from torch_parity import to_np  # noqa: E402

ARCH = "internvl2-2b"
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
    """The serving config in both packages on the same f32 weights."""
    jcfg = j_registry.serving_config(ARCH)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      j_init_params(jcfg, jax.random.PRNGKey(0)))
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    tok = get_tokenizer()
    prompts = [tok.encode(make_prompt(p), add_bos=True)
               for p in make_problems(2, seed=11)]
    return {"jcfg": jcfg, "cfg": t_registry.serving_config(ARCH), "jp": jp,
            "js": js,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "ts": scorer_from_numpy(jax.device_get(js), device="cpu"),
            "prompts": prompts, "kv_dtype": "f32"}


def _inputs(cfg, B, S, seed):
    """Tokens [B, S] and patch embeddings [B, num_modality_tokens, D]."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = rs.randn(B, cfg.num_modality_tokens, cfg.d_model) \
        .astype(np.float32)
    return toks, emb


def test_configs_padded_vocab_and_untied_head(setup):
    """full_config() and smoke_config() equal the JAX package's field by
    field; the full vocab of 92553 pads to 92672 and the head is untied
    (``lm_head`` [D, Vp] beside ``embed`` [Vp, D]); the port's init has
    the bridged tree's names and shapes."""
    for smoke in (False, True):
        assert t_registry.get_config(ARCH, smoke).__dict__ == \
            j_registry.get_config(ARCH, smoke).__dict__
    full = t_registry.get_config(ARCH)
    assert (full.arch_type, full.modality, full.num_modality_tokens,
            full.vocab_size, padded_vocab(full), full.tie_embeddings) == \
        ("vlm", "vision", 256, 92553, 92672, False)
    cfg, tp = setup["cfg"], setup["tp"]
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in _leaves(tp)}
    Vp = padded_vocab(cfg)
    assert tuple(tp["lm_head"].shape) == (cfg.d_model, Vp)
    assert tuple(tp["embed"].shape) == (Vp, cfg.d_model)
    assert "mlp" in tp["layers"] and "moe" not in tp["layers"]


def test_forward_full_with_modality_embeds_matches_jax(setup):
    """S = 24 over 16 patch embeddings, which replace the first 16 token
    embeddings: logits and hidden states at 1e-4, dense and through the
    flash wrapper (its plain version here). The embeddings of the first
    16 tokens themselves give the text forward back."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    toks, emb = _inputs(cfg, 2, 24, 0)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks),
                         modality_embeds=jnp.asarray(emb))
    for use_kernel in (False, True):
        to = tm.forward_full(tp, cfg, torch.from_numpy(toks),
                             use_kernel=use_kernel,
                             modality_embeds=torch.from_numpy(emb))
        for key in ("logits", "hidden"):
            np.testing.assert_allclose(to_np(to[key]), to_np(jo[key]), **TOL)
        assert float(to["aux_loss"]) == 0.0
    text = tm.forward_full(tp, cfg, torch.from_numpy(toks))
    assert np.abs(to_np(text["logits"]) - to_np(to["logits"])).max() > 1e-2
    own = tp["embed"][torch.from_numpy(toks[:, :cfg.num_modality_tokens])
                      .long()]
    same = tm.forward_full(tp, cfg, torch.from_numpy(toks),
                           modality_embeds=own)
    torch.testing.assert_close(same["logits"], text["logits"], rtol=0,
                               atol=0)


def test_lm_loss_with_modality_embeds_matches_jax(setup):
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    toks, emb = _inputs(cfg, 2, 24, 1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, :cfg.num_modality_tokens] = -1   # no loss on the image
    want = jm.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                      modality_embeds=jnp.asarray(emb))
    with torch.no_grad():
        got = tm.lm_loss(tp, cfg, torch.from_numpy(toks),
                         torch.from_numpy(labels),
                         modality_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_decode_after_a_vision_prefill_matches_jax(setup):
    """A 20-token prefill whose first 16 positions are patch embeddings,
    written into f32 pools, then three decode steps (dense and kernel
    wrappers in turn): logits and pools at 1e-4."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    B, S = 2, 20
    toks, emb = _inputs(cfg, B, S + 3, 2)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks[:, :S]), return_kv=True,
                         modality_embeds=jnp.asarray(emb))
    to = tm.forward_full(tp, cfg, torch.from_numpy(toks[:, :S]),
                         return_kv=True,
                         modality_embeds=torch.from_numpy(emb))
    jc = jm.write_prefill_kv(
        jcfg, jm.init_decode_cache(jcfg, B, CAP, kv_dtype="f32"), jo["kvs"],
        jnp.full((B,), S, jnp.int32))
    tc = tm.write_prefill_kv(
        cfg, tm.init_decode_cache(cfg, B, CAP, kv_dtype="f32", device="cpu"),
        to["kvs"], torch.full((B,), S, dtype=torch.int32))
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
    for k in ("k_pool", "v_pool"):
        np.testing.assert_allclose(to_np(tc[k]), to_np(jc[k]), **TOL)


@pytest.mark.parametrize("chunk", [None, 8])
def test_greedy_serve_matches_jax(setup, chunk):
    """STEP over 4 traces of two prompts in a pool tight enough to prune,
    one-shot or chunked prefill with the prefix cache: the port through
    its kernel wrappers (their plain versions here) equals the JAX
    engine's dense path."""
    kw = dict(max_batch=8, num_blocks=12, capacity=128, max_new_tokens=24,
              use_kernel=False, faults=None, kv_dtype="f32",
              prefix_cache=True, decode_horizon=4, prefill_chunk_size=chunk)
    _, jres = serve_jax(setup, "step", setup["prompts"], 4, **kw)
    eng, tres = serve_torch(setup, "step", setup["prompts"], 4,
                            **dict(kw, use_kernel=True))
    assert eng.fused_scorer
    assert sum(r.num_pruned for r in tres) > 0
    assert_same_results(jres, tres)
