"""The four dense GQA archs beside qwen3-4b-thinking (qwen3-1.7b,
granite-20b, phi4-mini-3.8b, starcoder2-3b) in the port against the JAX
package at their smoke configs: configs field by field, the params'
branches (untied ``lm_head``, no qk-norm), forward logits, decode steps
and a greedy ``serve_batch``.

They reach branches that qwen3-4b-thinking does not: granite-20b and
starcoder2-3b untie the embeddings and drop qk-norm; granite-20b is MQA
(48 query heads over one kv head; smoke: 4 over 1); phi4-mini-3.8b's
vocab of 200064 pads to 200192.

Tolerances as in ``tests/test_torch_model.py`` and
``tests/test_torch_engine.py``: f32 params and f32 pools, logits and
hidden states at 1e-4 (the frameworks sum in other orders); greedy
tokens, statuses and prune counts identical, step scores and
confidences within 1e-4.
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

ARCHS = ("qwen3-1.7b", "granite-20b", "phi4-mini-3.8b", "starcoder2-3b")
TOL = dict(rtol=1e-4, atol=1e-4)
# what each arch reaches: (tied embeddings, qk-norm, query heads per kv
# head in full_config(), padded vocab of full_config())
BRANCHES = {"qwen3-1.7b": (True, True, 2, 152064),
            "granite-20b": (False, False, 48, 49152),
            "phi4-mini-3.8b": (True, False, 3, 200192),
            "starcoder2-3b": (False, False, 12, 49152)}


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """An arch's serving config (smoke widths, the task tokenizer's
    vocab) in both packages, on the same f32 weights and scorer."""
    name = request.param
    jcfg = j_registry.serving_config(name)
    jp = _f32(j_init_params(jcfg, jax.random.PRNGKey(0)))
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    tok = get_tokenizer()
    prompts = [tok.encode(make_prompt(p), add_bos=True)
               for p in make_problems(2, seed=11)]
    return {"name": name, "jcfg": jcfg, "cfg": t_registry.serving_config(name),
            "jp": jp, "js": js,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "ts": scorer_from_numpy(jax.device_get(js), device="cpu"),
            "prompts": prompts, "kv_dtype": "f32"}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_configs_and_param_branches_match_jax(arch):
    """full_config() and smoke_config() equal the JAX package's field by
    field; the port's own init has the bridged tree's names and shapes:
    ``lm_head`` where the embeddings are untied, ``q_norm``/``k_norm``
    only with qk-norm, ``wk`` of one kv head for granite's MQA."""
    name = arch["name"]
    for smoke in (False, True):
        assert t_registry.get_config(name, smoke).__dict__ == \
            j_registry.get_config(name, smoke).__dict__
    assert arch["cfg"].__dict__ == arch["jcfg"].__dict__
    full = t_registry.get_config(name)
    tied, qk, group, vocab = BRANCHES[name]
    assert (full.tie_embeddings, full.qk_norm,
            full.num_heads // full.num_kv_heads, padded_vocab(full)) == \
        (tied, qk, group, vocab)
    cfg, tp = arch["cfg"], arch["tp"]
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in _leaves(tp)}
    assert ("lm_head" in tp) == (not tied)
    assert ("q_norm" in tp["layers"]["attn"]) == qk
    assert tp["layers"]["attn"]["wk"].shape[-1] == \
        cfg.num_kv_heads * cfg.head_dim


def test_forward_and_decode_match_jax(arch):
    """Logits and hidden states of a full forward (dense and through the
    flash wrapper's plain version), then three decode steps after a
    prefill written into an f32 pool, each against the JAX package's."""
    jcfg, cfg, jp, tp = arch["jcfg"], arch["cfg"], arch["jp"], arch["tp"]
    B, S, cap = 2, 16, 64
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks[:, :S]), return_kv=True)
    for use_kernel in (False, True):
        to = tm.forward_full(tp, cfg, torch.from_numpy(toks[:, :S]),
                             return_kv=True, use_kernel=use_kernel)
        np.testing.assert_allclose(to_np(to["logits"]), to_np(jo["logits"]),
                                   **TOL)
        np.testing.assert_allclose(to_np(to["hidden"]), to_np(jo["hidden"]),
                                   **TOL)
    jc = jm.write_prefill_kv(
        jcfg, jm.init_decode_cache(jcfg, B, cap, kv_dtype="f32"), jo["kvs"],
        jnp.full((B,), S, jnp.int32))
    tc = tm.write_prefill_kv(
        cfg, tm.init_decode_cache(cfg, B, cap, kv_dtype="f32", device="cpu"),
        to["kvs"], torch.full((B,), S, dtype=torch.int32))
    for i in range(3):
        nt, pos = toks[:, S + i:S + i + 1], np.full((B,), S + i, np.int32)
        jd = jm.decode_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                            window_len=cap)
        td = tm.decode_step(tp, cfg, torch.from_numpy(nt),
                            torch.from_numpy(pos), tc, window_len=cap,
                            use_kernel=bool(i % 2))
        jc, tc = jd["cache"], td["cache"]
        np.testing.assert_allclose(to_np(td["logits"]), to_np(jd["logits"]),
                                   **TOL)
    for k in ("k_pool", "v_pool"):
        np.testing.assert_allclose(to_np(tc[k]), to_np(jc[k]), **TOL)


def test_greedy_serve_matches_jax(arch):
    """STEP over 4 traces of two prompts in a pool tight enough to prune:
    the port (through its kernel wrappers, their plain versions here)
    equals the JAX engine's dense path."""
    kw = dict(max_batch=8, num_blocks=12, capacity=128, max_new_tokens=24,
              use_kernel=False, faults=None, kv_dtype="f32",
              prefix_cache=True, decode_horizon=4)
    _, jres = serve_jax(arch, "step", arch["prompts"], 4, **kw)
    eng, tres = serve_torch(arch, "step", arch["prompts"], 4,
                            **dict(kw, use_kernel=True))
    assert eng.fused_scorer
    assert_same_results(jres, tres)
