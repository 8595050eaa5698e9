"""The port's zamba2-2.7b hybrid (groups of Mamba2 layers, each followed
by one shared attention block) against the JAX package at the smoke
config: config and params, ``forward_full``, ``decode_step``, ``lm_loss``,
greedy ``Engine.serve`` and the engine's gates.

Tolerances. The model's functions run on f32 params at 1e-4 (the two
frameworks sum in other orders) and on bf16 params at the dense stack's
bf16 logits tolerance (``tests/test_torch_model.py``), 5e-2 absolute,
and 5e-2 absolute plus 3e-2 relative on hidden states, K/V and the
recurrent state: each layer rounds its activations to bf16, a
neighbouring bf16 value in one framework carries through the later
layers, and these tensors reach magnitude 4, where one bf16 ulp is
0.031. The engines run on bf16 params, as ``test_torch_mamba2_engine.py``
does (the JAX engine fails on f32 Mamba2 params, ROADMAP C): greedy
tokens, statuses, prune and preempt counts identical, step scores and
confidences within 1e-2 absolute.

The JAX engine cannot serve the hybrid as it stands: it writes a
prompt's attention K/V through ``write_prefill_kv``, whose hybrid branch
expects the (state, K/V) pair of a whole forward and fails on the K/V
alone (ROADMAP C). The parity runs give that one JAX engine the
function's dense scatter for the K/V, which is what its hybrid branch
does with them; nothing else of the JAX engine changes.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.core.pruning import make_policy as j_make_policy  # noqa: E402
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.data.arithmetic import make_prompt  # noqa: E402
from repro.data.tokenizer import get_tokenizer  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro.serving.evaluate import make_problems  # noqa: E402
from repro.serving.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.models.init import init_params, padded_vocab  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from test_torch_engine import POLICY_KW, _serve, assert_same_results  # noqa: E402
from torch_parity import to_np  # noqa: E402

ARCH = "zamba2-2.7b"
LOGITS = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=0, atol=5e-2)}
STATES = {"f32": dict(rtol=1e-4, atol=1e-4),
          "bf16": dict(rtol=3e-2, atol=5e-2)}
SCORES = 1e-2   # engine step scores and confidences, bf16 params
CAP = 128


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module")
def models():
    jcfg = j_registry.get_config(ARCH, smoke=True)
    cfg = t_registry.get_config(ARCH, smoke=True)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    out = {}
    for dt, p in (("bf16", jp), ("f32", _f32(jp))):
        out[dt] = (p, params_from_numpy(jax.device_get(p), device="cpu"))
    return jcfg, cfg, out


@pytest.fixture(scope="module")
def setup():
    jcfg = j_registry.serving_config(ARCH)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    tok = get_tokenizer()
    prompts = [tok.encode(make_prompt(p), add_bos=True)
               for p in make_problems(3, seed=11)]
    return {"jcfg": jcfg, "cfg": t_registry.serving_config(ARCH),
            "jp": jp, "js": js,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "ts": scorer_from_numpy(jax.device_get(js), device="cpu"),
            "prompts": prompts}


def _tokens(B, S, V, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# config and params
# ---------------------------------------------------------------------------

def test_config_and_params_match_jax(models):
    """The configs equal the JAX package's field by field; the bridged
    JAX params (layers stacked [G, per], one shared_attn block) keep
    their values, and the port's own init has the same names, shapes
    and dtypes."""
    for smoke in (False, True):
        assert t_registry.get_config(ARCH, smoke).__dict__ == \
            j_registry.get_config(ARCH, smoke).__dict__
    assert t_registry.serving_config(ARCH).__dict__ == \
        j_registry.serving_config(ARCH).__dict__
    full = t_registry.get_config(ARCH)
    assert (full.head_dim, full.ssm_heads, len(full.attention_layer_ids()),
            padded_vocab(full)) == (80, 80, 9, 32000)
    jcfg, cfg, params = models
    jp, tp = params["bf16"]
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
        np.testing.assert_array_equal(to_np(t), to_np(leaf))
    G, per = cfg.num_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every
    assert tp["layers"]["norm"].shape == (G, per, cfg.d_model)
    assert tp["shared_attn"]["attn"]["wq"].shape == \
        (cfg.d_model, cfg.num_heads * cfg.head_dim)
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in _leaves(own)} == \
        {k: (tuple(v.shape), v.dtype) for k, v in _leaves(tp)}


def test_cache_layout_matches_jax(models):
    """One pool entry per shared-attention invocation beside the
    recurrent state of every Mamba2 layer (f32 ssm, bf16 conv)."""
    jcfg, cfg, _ = models
    jc = jm.init_decode_cache(jcfg, 3, CAP)
    tc = tm.init_decode_cache(cfg, 3, CAP, device="cpu")
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k


# ---------------------------------------------------------------------------
# forward, decode, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_full_matches_jax(models, dt, use_kernel):
    """Logits, hidden states, the groups' end states and the shared
    block's K/V; ``use_kernel`` runs the SSD scan and flash wrappers
    (their plain versions here) in both packages."""
    jcfg, cfg, params = models
    jp, tp = params[dt]
    toks = _tokens(2, 64, cfg.vocab_size)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks), return_kv=True,
                         use_kernel=use_kernel)
    to = tm.forward_full(tp, cfg, torch.from_numpy(toks), return_kv=True,
                         use_kernel=use_kernel)
    np.testing.assert_allclose(to_np(to["logits"]), to_np(jo["logits"]),
                               **LOGITS[dt])
    np.testing.assert_allclose(to_np(to["hidden"]), to_np(jo["hidden"]),
                               **STATES[dt])
    (jss, jcs), (jk, jv) = jo["kvs"]
    (tss, tcs), (tk, tv) = to["kvs"]
    G, per = cfg.num_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every
    assert tss.shape[:3] == (G, per, 2) and tk.shape[:3] == (G, 2, 64)
    for j, t in ((jss, tss), (jcs, tcs), (jk, tk), (jv, tv)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(to_np(t), to_np(j), **STATES[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_steps_match_forward_and_jax(models, dt):
    """Three decode steps after a prefill written into the pools (in the
    params' dtype) and the recurrent state: each step's logits equal the
    JAX step's, and (f32) the full forward's last position."""
    jcfg, cfg, params = models
    jp, tp = params[dt]
    B, S = 2, 21
    toks = _tokens(B, S + 3, cfg.vocab_size, seed=1)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks[:, :S]), return_kv=True)
    to = tm.forward_full(tp, cfg, torch.from_numpy(toks[:, :S]),
                         return_kv=True)
    jc = jm.write_prefill_kv(
        jcfg, jm.init_decode_cache(jcfg, B, CAP, kv_dtype=dt), jo["kvs"],
        jnp.full((B,), S, jnp.int32))
    tc = tm.write_prefill_kv(
        cfg, tm.init_decode_cache(cfg, B, CAP, kv_dtype=dt, device="cpu"),
        to["kvs"], torch.full((B,), S, dtype=torch.int32))
    for i in range(3):
        nt, pos = toks[:, S + i:S + i + 1], np.full((B,), S + i, np.int32)
        jd = jm.decode_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                            window_len=CAP)
        td = tm.decode_step(tp, cfg, torch.from_numpy(nt),
                            torch.from_numpy(pos), tc, window_len=CAP)
        jc, tc = jd["cache"], td["cache"]
        np.testing.assert_allclose(to_np(td["logits"]), to_np(jd["logits"]),
                                   **LOGITS[dt])
        np.testing.assert_allclose(to_np(td["hidden"]), to_np(jd["hidden"]),
                                   **STATES[dt])
        if dt == "f32":
            full = tm.forward_full(tp, cfg, torch.from_numpy(
                toks[:, :S + i + 1]))
            np.testing.assert_allclose(to_np(td["logits"]),
                                       to_np(full["logits"][:, -1]),
                                       **LOGITS[dt])
    for k in ("ssm_state", "conv_state", "k_pool", "v_pool"):
        np.testing.assert_allclose(to_np(tc[k]), to_np(jc[k]), **STATES[dt])


def test_lm_loss_matches_jax(models):
    jcfg, cfg, params = models
    jp, tp = params["f32"]
    toks = _tokens(2, 32, cfg.vocab_size, seed=2)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jl = jm.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    tl = tm.lm_loss(tp, cfg, torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl[0] if isinstance(
        jl, tuple) else jl), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _kw(**kw):
    base = dict(max_batch=8, num_blocks=16, capacity=CAP, max_new_tokens=40,
                use_kernel=False, faults=None, prefix_cache=True,
                decode_horizon=4)
    base.update(kw)
    return base


def _greedy(mod, max_new):
    return mod(temperature=0.0, top_k=0, top_p=1.0, max_new_tokens=max_new)


def serve_jax(s, method, prompts, n, **kw):
    """The JAX engine's dense path, its prompt K/V written through the
    dense scatter of ``write_prefill_kv`` (see the module docstring)."""
    ecfg = je.EngineConfig(sampling=_greedy(JSamplingParams,
                                            kw["max_new_tokens"]), **kw)
    policy = j_make_policy(method, **POLICY_KW[method])
    eng = je.Engine(s["jp"], s["jcfg"], ecfg, policy,
                    scorer_params=s["js"] if policy.uses_scorer else None)
    scatter_cfg = dataclasses.replace(s["jcfg"], arch_type="dense",
                                      hybrid_attn_every=0)
    eng._write_kv = lambda sub, kvs, lens: jm.write_prefill_kv(
        scatter_cfg, sub, kvs, lens)
    return _serve(eng, je.Request, j_make_policy, method, prompts, n, None)


def serve_torch(s, method, prompts, n, **kw):
    ecfg = te.EngineConfig(sampling=_greedy(SamplingParams,
                                            kw["max_new_tokens"]), **kw)
    policy = make_policy(method, **POLICY_KW[method])
    eng = te.Engine(s["tp"], s["cfg"], ecfg, policy,
                    scorer_params=s["ts"] if policy.uses_scorer else None,
                    device="cpu")
    return _serve(eng, te.Request, make_policy, method, prompts, n, None)


@pytest.mark.parametrize("method", ["step", "sc"])
def test_greedy_serve_matches_jax(setup, method):
    """8 traces of one prompt in a 16-block pool: STEP prunes, SC
    preempts and re-prefills (pool K/V and slot state both rebuilt); the
    port through its kernel wrappers (their plain versions here) equals
    the JAX engine."""
    _, jres = serve_jax(setup, method, setup["prompts"][:1], 8, **_kw())
    eng, tres = serve_torch(setup, method, setup["prompts"][:1], 8,
                            **_kw(use_kernel=True))
    assert eng.fused_scorer == (method == "step")
    assert_same_results(jres, tres, tol=SCORES)
    res = tres[0]
    if method == "step":
        assert res.num_pruned > 0 and res.num_preemptions == 0
        assert res.wait_s == 0.0
    else:
        assert res.num_preemptions > 0 and res.num_pruned == 0


def test_decode_horizon_drifts_stopped_lanes_in_both_packages(setup):
    """As for mamba2 (ROADMAP C): under a 12-block pool a short free list
    stops lanes inside a horizon, their Mamba2 state keeps taking the
    re-fed token (their attention writes go to the scratch block), and
    the greedy traces of one prompt leave their shared sequence at
    horizon 4 but not at horizon 1. Both packages agree at each
    horizon."""
    traces = {}
    for horizon in (1, 4):
        kw = _kw(num_blocks=12, decode_horizon=horizon)
        _, jres = serve_jax(setup, "step", setup["prompts"][:1], 8, **kw)
        _, tres = serve_torch(setup, "step", setup["prompts"][:1], 8, **kw)
        assert_same_results(jres, tres, tol=SCORES)
        traces[horizon] = [t.output_tokens for t in tres[0].traces]

    def one_sequence(outs):
        longest = max(outs, key=len)
        return all(o == longest[:len(o)] for o in outs)

    assert one_sequence(traces[1])
    assert not one_sequence(traces[4])


class RecordingEngine(te.Engine):
    """Records the prompt K/V and slot-state writes as they happen."""

    def __init__(self, *args, **kw):
        self.events = []
        super().__init__(*args, **kw)

    def _write_slot_state(self, cache, slot_state, slot):
        out = super()._write_slot_state(cache, slot_state, slot)
        self.events.append(("state", slot, slot_state[0].clone()))
        return out

    def _write_prefix_kv(self, cache, attn_kvs, block_row, seq_len):
        self.events.append(("kv", tuple(block_row), seq_len))
        return super()._write_prefix_kv(cache, attn_kvs, block_row, seq_len)


def test_gates_and_prefill_writes_follow_the_reference(setup):
    """The reference's gates for the hybrid: a chunk size falls back to
    one-shot prefill (same tokens as without it), the prefix cache comes
    back off, and an int8/fp8 pool or a mesh raises NotImplementedError,
    in both packages. A STEP prompt's K/V goes into the pool once and
    each forked trace's slot gets its end state, flattened over the
    Mamba2 layers."""
    s = setup
    policy = make_policy("step")
    chunked = _kw(prefill_chunk_size=8, max_tokens_per_step=32,
                  decode_horizon=1, max_new_tokens=16)
    plain = dict(chunked, prefill_chunk_size=None, max_tokens_per_step=None)
    _, jres = serve_jax(s, "step", s["prompts"][:1], 4, **chunked)
    results = []
    for kw in (chunked, plain):
        ecfg = te.EngineConfig(sampling=_greedy(SamplingParams, 16), **kw)
        eng = RecordingEngine(s["tp"], s["cfg"], ecfg, policy,
                              scorer_params=s["ts"], device="cpu")
        assert eng.prefix_cache is None and not eng._chunk_supported
        results.append(eng.serve(s["prompts"][0], 4))
    assert_same_results(jres, results[:1], tol=SCORES)
    assert [t.output_tokens for t in results[0].traces] == \
        [t.output_tokens for t in results[1].traces]
    kv = [e for e in eng.events if e[0] == "kv"]
    states = [e for e in eng.events if e[0] == "state"]
    assert len(kv) == 1 and kv[0][2] == len(s["prompts"][0])
    assert len({e[1] for e in states}) == 4
    end = tm.forward_full(s["tp"], s["cfg"],
                          torch.tensor([s["prompts"][0]], dtype=torch.int32),
                          return_kv=True)["kvs"][0][0]
    want = end.reshape(-1, *end.shape[2:])[:, 0]
    for e in states:
        torch.testing.assert_close(e[2], want, rtol=0, atol=0)
    jeng = je.Engine(s["jp"], s["jcfg"], je.EngineConfig(faults=None),
                     j_make_policy("step"))
    assert jeng.prefix_cache is None
    for kv_dtype in ("int8", "fp8"):
        with pytest.raises(NotImplementedError):
            je.Engine(s["jp"], s["jcfg"],
                      je.EngineConfig(faults=None, kv_dtype=kv_dtype),
                      j_make_policy("step"))
        with pytest.raises(NotImplementedError, match="dense GQA"):
            te.Engine(s["tp"], s["cfg"],
                      te.EngineConfig(faults=None, kv_dtype=kv_dtype),
                      policy, device="cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(NotImplementedError, match="recurrent"):
        je.Engine(s["jp"], s["jcfg"], je.EngineConfig(faults=None),
                  j_make_policy("step"), mesh=mesh)
    with pytest.raises(NotImplementedError, match="A10"):
        te.Engine(s["tp"], s["cfg"], te.EngineConfig(faults=None), policy,
                  mesh=object(), device="cpu")


def test_shared_scratch_slots_take_their_last_writer(models, monkeypatch):
    """Frozen lanes all write the scratch block and read it back, and the
    hybrid carries what they read into their recurrent state: each shared
    slot takes its last lane's K/V, as the CPU's scatter leaves it (on
    CUDA a scatter keeps any lane's value). Here lanes 0, 2 and 3 share
    one scratch slot and lane 1 owns its block; the step equals, bit for
    bit, the same step with every lane writing its own value through the
    CPU's scatter."""
    jcfg, cfg, params = models
    _, tp = params["f32"]
    bt = torch.tensor([[0, 0], [3, 4], [0, 0], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([5, 20, 5, 5], dtype=torch.int32)
    assert tl.last_writer(bt, pos, CAP, cfg.kv_block_size).tolist() == \
        [3, 1, 3, 3]
    toks = torch.tensor([[3], [4], [5], [6]], dtype=torch.int32)

    def step():
        cache = tm.init_decode_cache(cfg, 4, CAP, num_blocks=6,
                                     kv_dtype="f32", device="cpu")
        cache["block_tables"] = bt
        out = tm.decode_step(tp, cfg, toks, pos, cache, window_len=CAP)
        return out["logits"], cache

    logits, cache = step()
    monkeypatch.setattr(tl, "last_writer",
                        lambda bt_, pos_, *a: torch.arange(len(pos_)))
    want_logits, want = step()
    assert torch.equal(logits, want_logits)
    for key in ("k_pool", "v_pool", "ssm_state", "conv_state"):
        assert torch.equal(cache[key], want[key]), key
