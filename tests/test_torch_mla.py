"""The port's deepseek-v2-236b (multi-head latent attention over a latent
paged pool; 160 routed experts top 6 plus 2 shared at full width) against
the JAX package at its serving config: configs and params, both branches
of ``mla_attention_full``, the absorbed paged decode (its slot rule under
a wrapping window included), the model functions, ``moe_layer`` with
shared experts in both capacity regimes, greedy STEP serves against the
JAX engine, and the engine's gates.

The JAX engine serves MLA on its dense path (its ``resolve_use_kernel``
refuses the kernels), one-shot prefill and no prefix cache; the port
mirrors each gate.

Tolerances: the layers and model functions on f32 params at 1e-4, as
``tests/test_torch_model.py``; ``moe_layer`` at 1e-5, as
``tests/test_torch_moe.py``; greedy serves on f32 params and pools with
tokens, statuses and prune counts identical and step scores and
confidences within 1e-4 (``tests/test_torch_engine.py``), and on bf16
params and pools within 1e-2 (``tests/test_torch_engine_paths.py``).
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
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.data.arithmetic import make_prompt  # noqa: E402
from repro.data.tokenizer import get_tokenizer  # noqa: E402
from repro.models import kv_quant as j_kvq  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro.serving.evaluate import make_problems  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.models import kv_quant as t_kvq  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.models.init import init_params, padded_vocab  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from test_torch_engine import assert_same_results, serve_jax, serve_torch  # noqa: E402
from torch_parity import to_np  # noqa: E402

ARCH = "deepseek-v2-236b"
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CAP = 64


def _cast(tree, dt):
    return jax.tree.map(lambda x: x.astype(dt), tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _make(dt=jnp.float32, kv_dtype="f32"):
    jcfg = j_registry.serving_config(ARCH)
    cfg = t_registry.serving_config(ARCH)
    jp = _cast(j_init_params(jcfg, jax.random.PRNGKey(0)), dt)
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    tok = get_tokenizer()
    prompts = [tok.encode(make_prompt(p), add_bos=True)
               for p in make_problems(2, seed=11)]
    return {"jcfg": jcfg, "cfg": cfg, "jp": jp, "js": js,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "ts": scorer_from_numpy(jax.device_get(js), device="cpu"),
            "prompts": prompts, "kv_dtype": kv_dtype}


@pytest.fixture(scope="module")
def setup():
    """The serving config (smoke widths, the task tokenizer's vocab) in
    both packages, on the same f32 weights."""
    return _make()


def _with(s, **fields):
    """``setup`` with both configs' ``fields`` replaced (same weights)."""
    return {**s, "jcfg": dataclasses.replace(s["jcfg"], **fields),
            "cfg": dataclasses.replace(s["cfg"], **fields)}


def _layer(s, name, layer=0):
    """One layer's ``name`` params (attn, moe) in both packages."""
    jp = jax.tree.map(lambda x: x[layer], s["jp"]["layers"][name])
    tp = tm._index(s["tp"]["layers"][name], layer)
    return jp, tp


def _tokens(B, S, seed, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_and_params_match_jax(setup):
    """full_config() and smoke_config() equal the JAX package's field by
    field; the port's init has the bridged tree's names and shapes: MLA's
    eight attention params, 160 routed experts and a shared SwiGLU of
    two experts' width at full size (the smoke config: 4 and 1)."""
    for smoke in (False, True):
        assert t_registry.get_config(ARCH, smoke).__dict__ == \
            j_registry.get_config(ARCH, smoke).__dict__
    full = t_registry.get_config(ARCH)
    assert (full.use_mla, full.kv_lora_rank, full.q_lora_rank,
            full.qk_nope_head_dim, full.qk_rope_head_dim, full.v_head_dim,
            full.num_heads, full.num_experts, full.num_experts_per_tok,
            full.num_shared_experts, full.moe_d_ff, full.d_model,
            padded_vocab(full), full.tie_embeddings) == \
        (True, 512, 1536, 128, 64, 128, 128, 160, 6, 2, 1536, 5120, 102400,
         False)
    assert full.kv_cache_dims_per_token == 576
    cfg, tp = setup["cfg"], setup["tp"]
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in _leaves(tp)}
    L, D, H = cfg.num_layers, cfg.d_model, cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    Lk, Lq = cfg.kv_lora_rank, cfg.q_lora_rank
    assert {k: tuple(v.shape) for k, v in tp["layers"]["attn"].items()} == {
        "wq_a": (L, D, Lq), "wq_b": (L, Lq, H * (nd + rd)),
        "wkv_a": (L, D, Lk + rd), "wk_b": (L, Lk, H * nd),
        "wv_b": (L, Lk, H * vd), "wo": (L, H * vd, D),
        "q_a_norm": (L, Lq), "kv_a_norm": (L, Lk)}
    F, E, n_sh = cfg.moe_d_ff, cfg.num_experts, cfg.num_shared_experts
    moe = tp["layers"]["moe"]
    assert tuple(moe["experts"]["w_gate"].shape) == (L, E, D, F)
    assert tuple(moe["shared"]["w_down"].shape) == (L, F * n_sh, D)
    # the output projection's scale counts the layers, as the JAX init's
    std = own["layers"]["attn"]["wo"].float().std().item()
    want = 1.0 / np.sqrt(H * vd) / np.sqrt(2 * L)
    assert abs(std / want - 1) < 0.05


# ---------------------------------------------------------------------------
# the MLA layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [24, 1536])
def test_mla_attention_full_matches_jax(setup, S):
    """Both branches at 1e-4: S = 24 materialises the nope and rope
    scores, S = 1536 (past ``CHUNKED_ATTN_THRESHOLD``) folds the roped key
    into per-head keys and runs the chunked online softmax. The latent
    entries [c_kv | k_rope] too."""
    assert (S > tl.CHUNKED_ATTN_THRESHOLD) == (S > 1024)
    jp, tp = _layer(setup, "attn")
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    B = 2 if S < 1024 else 1
    x = np.random.RandomState(S).randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jo, jkv = jl.mla_attention_full(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos), return_kv=True)
    to, tkv = tl.mla_attention_full(tp, cfg, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()),
                                    return_kv=True)
    np.testing.assert_allclose(to_np(to), to_np(jo), **TOL)
    np.testing.assert_allclose(to_np(tkv), to_np(jkv), **TOL)
    assert tuple(tkv.shape) == (B, S, cfg.kv_lora_rank
                                + cfg.qk_rope_head_dim)


@pytest.mark.parametrize("window_len", [0, 40])
def test_mla_attention_decode_matches_jax(setup, window_len):
    """The absorbed decode over a pool of random latent entries, lanes at
    ragged positions, at 1e-4, output and pool. With a 40-slot window the
    lanes past it write slot ``position % 40`` and attend over
    ``min(position + 1, 40)`` slots (the slot rule the engine's capacity
    sets); without one, slot = position."""
    jp, tp = _layer(setup, "attn")
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    rs = np.random.RandomState(window_len)
    B, bs, bp = 4, cfg.kv_block_size, 4
    W = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    NB = B * bp + 1
    pool = rs.randn(NB, bs, W).astype(np.float32)
    bt = (1 + rs.permutation(B * bp)).reshape(B, bp).astype(np.int32)
    pos = np.asarray([3, 17, 45, 63], np.int32)
    x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
    jo, jpool = jl.mla_attention_decode(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
        {"kv_pool": jnp.asarray(pool), "block_tables": jnp.asarray(bt),
         "window_len": window_len})
    tpool = torch.from_numpy(pool.copy())
    to = tl.mla_attention_decode(
        tp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
        {"kv_pool": tpool, "block_tables": torch.from_numpy(bt),
         "window_len": window_len})
    np.testing.assert_allclose(to_np(to), to_np(jo), **TOL)
    np.testing.assert_allclose(tpool.numpy(), to_np(jpool), **TOL)
    slot = pos % window_len if window_len else pos
    changed = np.argwhere((tpool.numpy() != pool).any(-1))
    want = {(int(bt[b, s // bs]), int(s % bs)) for b, s in enumerate(slot)}
    assert {tuple(c) for c in changed} == want
    if window_len:
        assert (pos >= window_len).any()


def test_mla_decode_writer_keeps_the_last_lane(setup):
    """Lanes that share a slot (frozen lanes on the scratch block) write
    its last lane's entry when ``writer`` is given, as the CPU scatter
    keeps it: the pool is the same with and without the writer here,
    and the shared slot holds lane 3's entry (the one lane 3 writes when
    no other lane shares its slot)."""
    jp, tp = _layer(setup, "attn")
    cfg = setup["cfg"]
    rs = np.random.RandomState(5)
    B, bs = 4, cfg.kv_block_size
    W = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    bt = torch.tensor([[1, 2], [0, 0], [0, 0], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([20, 7, 7, 7], dtype=torch.int32)
    x = torch.from_numpy(rs.randn(B, 1, cfg.d_model).astype(np.float32))
    writer = tl.last_writer(bt, pos, 64, bs)
    assert writer.tolist() == [0, 3, 3, 3]
    pools = []
    for w in (None, writer):
        pool = torch.zeros(3, bs, W)
        tl.mla_attention_decode(tp, cfg, x, pos,
                                {"kv_pool": pool, "block_tables": bt,
                                 "window_len": 64}, writer=w)
        pools.append(pool)
    torch.testing.assert_close(pools[0], pools[1], rtol=0, atol=0)
    alone = torch.zeros(3, bs, W)
    tl.mla_attention_decode(tp, cfg, x, torch.tensor([20, 30, 31, 7]),
                            {"kv_pool": alone, "block_tables": bt[[0, 0, 0,
                                                                   3]],
                             "window_len": 64})
    torch.testing.assert_close(pools[1][0, 7], alone[0, 7], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# moe_layer with shared experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_moe_layer_with_shared_experts_matches_jax(setup, factor):
    """The routed experts plus the shared SwiGLU at 1e-5, output and aux
    loss. At factor 1.25, 16 identical decode lanes give each of the two
    chosen experts int(1.25 * 16 * 2 / 4) = 10 pairs: lanes 10-15 keep
    only the shared experts' output, in both packages."""
    jp, tp = _layer(setup, "moe")
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    rs = np.random.RandomState(1)
    same = np.repeat(rs.randn(1, 1, cfg.d_model), 16, axis=0) \
        .astype(np.float32)
    for x in (same, rs.randn(2, 24, cfg.d_model).astype(np.float32)):
        jo, ja = jl.moe_layer(jp, jcfg, jnp.asarray(x),
                              capacity_factor=factor)
        to, ta = tl.moe_layer(tp, cfg, torch.from_numpy(x),
                              capacity_factor=factor)
        np.testing.assert_allclose(to_np(to), to_np(jo), **MOE_TOL)
        np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)
    to, _ = tl.moe_layer(tp, cfg, torch.from_numpy(same),
                         capacity_factor=factor)
    shared = tl.swiglu(tp["shared"], torch.from_numpy(same))
    routed = to_np(to - shared)[:, 0]
    if factor == 1.25:
        np.testing.assert_allclose(routed[10:], 0.0, atol=1e-6)
        assert (np.abs(routed[:10]) > 1e-3).any(-1).all()
    else:
        assert (np.abs(routed) > 1e-3).any(-1).all()


def test_moe_capacity_at_full_width():
    """The full config's decode capacity: 16 lanes in one group of 16
    (``_moe_group_size`` targets 256 from 32 experts on) give each of the
    160 experts max(1, int(1.25 * 16 * 6 / 160)) = 1 pair, in both
    packages."""
    full = t_registry.get_config(ARCH)
    E, K = full.num_experts, full.num_experts_per_tok
    for T in (16, 256, 1000, 4096):
        assert tl._moe_group_size(T, E) == jl._moe_group_size(T, E)
    gs = tl._moe_group_size(16, E)
    assert gs == 16
    assert max(1, int(full.moe_capacity_factor * gs * K / E)) == 1
    # 16 identical lanes: each chosen expert keeps lane 0's pair only
    sel = torch.arange(K).expand(1, 16, K)
    _, _, keep = tl.moe_queue(sel, E, 1)
    assert keep[0, 0].all() and not keep[0, 1:].any()


# ---------------------------------------------------------------------------
# the model's functions
# ---------------------------------------------------------------------------

def _prefill(s, toks, S):
    """forward_full(return_kv) of ``toks[:, :S]`` written into fresh
    latent pools of both packages: (jax cache, torch cache)."""
    jcfg, cfg = s["jcfg"], s["cfg"]
    B = toks.shape[0]
    jo = jm.forward_full(s["jp"], jcfg, jnp.asarray(toks[:, :S]),
                         return_kv=True)
    to = tm.forward_full(s["tp"], cfg, torch.from_numpy(toks[:, :S]),
                         return_kv=True)
    assert tuple(to["kvs"].shape) == tuple(jo["kvs"].shape) == (
        cfg.num_layers, B, S, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    jc = jm.write_prefill_kv(jcfg, jm.init_decode_cache(jcfg, B, CAP,
                                                        kv_dtype="f32"),
                             jo["kvs"], jnp.full((B,), S, jnp.int32))
    tc = tm.write_prefill_kv(cfg, tm.init_decode_cache(cfg, B, CAP,
                                                       kv_dtype="f32",
                                                       device="cpu"),
                             to["kvs"], torch.full((B,), S,
                                                   dtype=torch.int32))
    return jc, tc


def test_forward_full_matches_jax(setup):
    """Logits, hidden states and the summed aux loss at 1e-4; the kernel
    flag leaves MLA dense, as in the JAX package."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    toks = _tokens(2, 24, 0, cfg.vocab_size)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks))
    outs = [tm.forward_full(tp, cfg, torch.from_numpy(toks),
                            use_kernel=k) for k in (False, True)]
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(to_np(outs[0][key]), to_np(jo[key]),
                                   **TOL)
        torch.testing.assert_close(outs[1][key], outs[0][key], rtol=0,
                                   atol=0)
    np.testing.assert_allclose(float(outs[0]["aux_loss"]),
                               float(jo["aux_loss"]), **MOE_TOL)
    assert float(outs[0]["aux_loss"]) > 0


def test_decode_steps_match_jax(setup):
    """Three decode steps after a 16-token prefill: logits, hidden states
    and the latent pool at 1e-4; the last step's logits equal the full
    forward's at the same position within 1e-4."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    B, S = 2, 16
    toks = _tokens(B, S + 3, 1, cfg.vocab_size)
    jc, tc = _prefill(setup, toks, S)
    for i in range(3):
        nt, pos = toks[:, S + i:S + i + 1], np.full((B,), S + i, np.int32)
        jd = jm.decode_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                            window_len=CAP)
        td = tm.decode_step(tp, cfg, torch.from_numpy(nt),
                            torch.from_numpy(pos), tc, window_len=CAP)
        jc, tc = jd["cache"], td["cache"]
        np.testing.assert_allclose(to_np(td["logits"]), to_np(jd["logits"]),
                                   **TOL)
        np.testing.assert_allclose(to_np(td["hidden"]), to_np(jd["hidden"]),
                                   **TOL)
    np.testing.assert_allclose(to_np(tc["kv_pool"]), to_np(jc["kv_pool"]),
                               **TOL)
    full = tm.forward_full(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(td["logits"]),
                               to_np(full["logits"][:, -1]), **TOL)


def test_lm_loss_includes_the_aux_loss(setup):
    """``lm_loss`` equals the JAX one (NLL plus 0.01 times the summed aux
    loss of the MoE layers)."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    toks = _tokens(2, 24, 4, cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -3:] = -1
    want = jm.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    with torch.no_grad():
        got = tm.lm_loss(tp, cfg, torch.from_numpy(toks),
                         torch.from_numpy(labels))
        bare = tm.lm_loss(tp, cfg, torch.from_numpy(toks),
                          torch.from_numpy(labels), aux_weight=0.0)
        aux = tm.forward_full(tp, cfg, torch.from_numpy(toks))["aux_loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got - bare), 0.01 * float(aux),
                               rtol=1e-4)


def test_copy_kv_block_copies_the_latent_pool(setup):
    """The copy-on-write step of prefix sharing copies MLA's latent pool
    in both packages."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    tc = tm.init_decode_cache(cfg, 2, CAP, kv_dtype="f32", device="cpu")
    assert "kv_pool" in tm.POOL_KEYS and set(tc) == {"kv_pool",
                                                     "block_tables"}
    vals = torch.randn(tc["kv_pool"][:, 3].shape)
    tc["kv_pool"][:, 3] = vals
    tm.copy_kv_block(cfg, tc, 3, 5)
    jc = jm.init_decode_cache(jcfg, 2, CAP, kv_dtype="f32")
    jc["kv_pool"] = jc["kv_pool"].at[:, 3].set(jnp.asarray(vals.numpy()))
    jc = jm.copy_kv_block(jcfg, jc, 3, 5)
    np.testing.assert_array_equal(tc["kv_pool"].numpy(),
                                  np.asarray(jc["kv_pool"]))
    for kv_dtype, dt in (("bf16", torch.bfloat16), ("int8", torch.bfloat16)):
        assert tm.init_decode_cache(cfg, 2, CAP, kv_dtype=kv_dtype,
                                    device="cpu")["kv_pool"].dtype == dt


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve_kw(kv_dtype, **kw):
    return dict(dict(max_batch=8, num_blocks=12, capacity=128,
                     max_new_tokens=24, use_kernel=False, faults=None,
                     kv_dtype=kv_dtype, decode_horizon=4), **kw)


@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_greedy_serve_matches_jax(setup, factor, monkeypatch):
    """STEP over 4 traces of two prompts, a pool tight enough to prune,
    an f32 pool: the port's engine ("auto": dense for MLA) equals the JAX
    engine's. At factor 1.25 an expert takes int(1.25 * 8 * 2 / 4) = 5 of
    a decode iteration's 16 pairs (8 lanes, frozen and dead ones
    included): the serve drops pairs."""
    s = _with(setup, moe_capacity_factor=factor)
    kw = _serve_kw("f32")
    _, jres = serve_jax(s, "step", s["prompts"], 4, **kw)
    dropped = [0]
    groups = tl._moe_groups

    def counting(pe, xg, sel, w, E, capacity, **kw):
        dropped[0] += int((~tl.moe_queue(sel, E, capacity)[2]).sum())
        return groups(pe, xg, sel, w, E, capacity, **kw)

    monkeypatch.setattr(tl, "_moe_groups", counting)
    eng, tres = serve_torch(s, "step", s["prompts"], 4,
                            **dict(kw, use_kernel="auto"))
    assert not eng.use_kernel and not eng.fused_scorer
    assert eng.prefix_cache is None and not eng._chunk_supported
    assert sum(r.num_pruned for r in tres) > 0
    assert (dropped[0] > 0) == (factor == 1.25)
    assert_same_results(jres, tres)


def test_bf16_serve_matches_jax():
    """bf16 weights and pool: identical greedy tokens, statuses and prune
    decisions; step scores and confidences within 1e-2."""
    s = _make(jnp.bfloat16, "bf16")
    kw = _serve_kw("bf16")
    _, jres = serve_jax(s, "step", s["prompts"][:1], 4, **kw)
    _, tres = serve_torch(s, "step", s["prompts"][:1], 4, **kw)
    assert_same_results(jres, tres, tol=1e-2)


def test_engine_gates_follow_the_reference(setup):
    """MLA takes no kernel: ``use_kernel=True`` raises with the JAX
    engine's reason, "auto" resolves dense on every device (so the scorer
    is the plain one); int8/fp8 pools raise; no chunked prefill (the
    prefill step refuses it) and so no prefix cache; a mesh raises."""
    cfg, jcfg, tp = setup["cfg"], setup["jcfg"], setup["tp"]
    for device in ("cpu", "cuda"):
        assert te.resolve_use_kernel("auto", cfg,
                                     torch.device(device)) is False
    with pytest.raises(NotImplementedError, match="no Pallas kernel"):
        je.resolve_use_kernel(True, jcfg)
    with pytest.raises(NotImplementedError, match="no kernel path"):
        te.resolve_use_kernel(True, cfg, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="no kernel path"):
        te.Engine(tp, cfg, te.EngineConfig(**_serve_kw("f32",
                                                       use_kernel=True)),
                  make_policy("step"), device="cpu")
    for kv_dtype in ("int8", "fp8"):
        with pytest.raises(NotImplementedError, match="dense GQA"):
            te.Engine(tp, cfg, te.EngineConfig(**_serve_kw(kv_dtype)),
                      make_policy("step"), device="cpu")
    assert not tm.supports_chunked_prefill(cfg)
    assert not jm.supports_chunked_prefill(jcfg)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tm.prefill_chunk_step(tp, cfg, torch.zeros((1, 4), dtype=torch.int32),
                              torch.zeros((1, 4), dtype=torch.int32),
                              torch.ones((1, 4), dtype=torch.bool), {}, 64)
    eng = te.Engine(tp, cfg, te.EngineConfig(**_serve_kw(
        "f32", prefix_cache=True, prefill_chunk_size=8)),
        make_policy("step"), device="cpu")
    assert eng.prefix_cache is None and not eng._chunk_supported
    with pytest.raises(NotImplementedError, match="mesh"):
        te.Engine(tp, cfg, te.EngineConfig(**_serve_kw("bf16")),
                  make_policy("step"), mesh=object(), device="cpu")


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_pool_block_bytes_match(setup, kv_dtype):
    """One block's bytes: 576 latent scalars per token and layer at full
    width, as the JAX package counts them."""
    for jc, tc in ((setup["jcfg"], setup["cfg"]),
                   (j_registry.get_config(ARCH),
                    t_registry.get_config(ARCH))):
        assert t_kvq.pool_block_bytes(tc, kv_dtype) == \
            j_kvq.pool_block_bytes(jc, kv_dtype)
    full = t_registry.get_config(ARCH)
    assert t_kvq.pool_block_bytes(full, "bf16") == 60 * 16 * 576 * 2
