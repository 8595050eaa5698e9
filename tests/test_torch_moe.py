"""The port's mixtral-8x7b (MoE feed-forward, sliding-window attention)
against the JAX package at its smoke config: configs and params,
``moe_layer`` in both capacity regimes, ``forward_full``, decode,
``prefill_chunk_step``, ``lm_loss``, greedy STEP serves and the
decode-window quirk.

The window must bite: the smoke config's window (128) is longer than any
prompt plus generation here, so the model tests run a variant with
``sliding_window=8`` and prompts and sequences longer than 8.

Capacity. The smoke config's capacity factor 8.0 drops nothing; the full
config's 1.25 drops (token, k) pairs past ``int(1.25 * gs * K / E)`` in
the flattened group order, padded chunk slots and frozen decode lanes
included. Each regime is held to the reference, not to the other.

Tolerances: ``moe_layer`` on f32 at 1e-5 (the two frameworks sum the
products in other orders; the dispatch and combine themselves are exact:
each slot holds one token); the model functions on f32 params at 1e-4,
as ``tests/test_torch_model.py``; greedy serves on f32 params and pools
with tokens, statuses and prune counts identical and step scores and
confidences within 1e-4, as ``tests/test_torch_engine.py``.
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
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving.evaluate import make_problems  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.models.init import init_params, padded_vocab  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from test_torch_engine import assert_same_results, serve_jax, serve_torch  # noqa: E402
from torch_parity import to_np  # noqa: E402

ARCH = "mixtral-8x7b"
WINDOW = 8
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CAP = 64


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def setup():
    """The serving config (smoke widths, the task tokenizer's vocab) with
    an 8-token window, in both packages, on the same f32 weights."""
    jcfg = dataclasses.replace(j_registry.serving_config(ARCH),
                               sliding_window=WINDOW)
    cfg = dataclasses.replace(t_registry.serving_config(ARCH),
                              sliding_window=WINDOW)
    jp = _f32(j_init_params(jcfg, jax.random.PRNGKey(0)))
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    tok = get_tokenizer()
    prompts = [tok.encode(make_prompt(p), add_bos=True)
               for p in make_problems(2, seed=11)]
    assert min(len(p) for p in prompts) > WINDOW
    return {"jcfg": jcfg, "cfg": cfg, "jp": jp, "js": js,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "ts": scorer_from_numpy(jax.device_get(js), device="cpu"),
            "prompts": prompts, "kv_dtype": "f32"}


def _with(s, **fields):
    """``setup`` with both configs' ``fields`` replaced (same weights)."""
    return {**s, "jcfg": dataclasses.replace(s["jcfg"], **fields),
            "cfg": dataclasses.replace(s["cfg"], **fields)}


def _moe(s, layer=0):
    """One layer's MoE params in both packages."""
    jp = jax.tree.map(lambda x: x[layer], s["jp"]["layers"]["moe"])
    tp = tm._index(s["tp"]["layers"]["moe"], layer)
    return jp, tp


def _tokens(B, S, seed, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_configs_and_param_branches_match_jax(setup):
    """full_config() and smoke_config() equal the JAX package's field by
    field; the port's init has the bridged tree's names and shapes: a
    router [L, D, E], the experts stacked [L, E, ...], no dense MLP, an
    untied ``lm_head``."""
    for smoke in (False, True):
        assert t_registry.get_config(ARCH, smoke).__dict__ == \
            j_registry.get_config(ARCH, smoke).__dict__
    full = t_registry.get_config(ARCH)
    assert (full.num_experts, full.num_experts_per_tok, full.moe_d_ff,
            full.sliding_window, full.moe_capacity_factor,
            padded_vocab(full), full.tie_embeddings) == \
        (8, 2, 14336, 4096, 1.25, 32000, False)
    cfg, tp = setup["cfg"], setup["tp"]
    own = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == \
        {k: tuple(v.shape) for k, v in _leaves(tp)}
    L, D, E, F = (cfg.num_layers, cfg.d_model, cfg.num_experts,
                  cfg.moe_d_ff)
    moe = tp["layers"]["moe"]
    assert "mlp" not in tp["layers"] and "shared" not in moe
    assert tuple(moe["router"].shape) == (L, D, E)
    assert {k: tuple(v.shape) for k, v in moe["experts"].items()} == {
        "w_gate": (L, E, D, F), "w_up": (L, E, D, F),
        "w_down": (L, E, F, D)}
    assert tuple(tp["lm_head"].shape) == (D, padded_vocab(cfg))


def test_moe_group_size_matches_jax():
    for T in (1, 7, 16, 24, 96, 1000, 1024, 1025, 2048, 4608, 8192):
        for E in (4, 8, 32, 160):
            assert tl._moe_group_size(T, E) == jl._moe_group_size(T, E)


# ---------------------------------------------------------------------------
# moe_layer
# ---------------------------------------------------------------------------

def test_moe_layer_matches_jax_without_drops(setup):
    """The smoke config's capacity factor 8.0 keeps every (token, k) pair:
    output and aux loss at 1e-5."""
    jp, tp = _moe(setup)
    x = np.random.RandomState(0).randn(2, 24, setup["cfg"].d_model) \
        .astype(np.float32)
    jo, ja = jl.moe_layer(jp, setup["jcfg"], jnp.asarray(x))
    to, ta = tl.moe_layer(tp, setup["cfg"], torch.from_numpy(x))
    np.testing.assert_allclose(to_np(to), to_np(jo), **MOE_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)


def test_moe_layer_capacity_drops_match_jax(setup):
    """At factor 1.25, 16 identical decode lanes pick the same two
    experts, each of which takes int(1.25 * 16 * 2 / 4) = 10 pairs in lane
    order: lanes 10-15 get exactly zero in both packages, lanes 0-9 the
    same output. 16 distinct lanes drop other pairs, the same ones."""
    jp, tp = _moe(setup)
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    rs = np.random.RandomState(1)
    same = np.repeat(rs.randn(1, 1, cfg.d_model), 16, axis=0) \
        .astype(np.float32)
    distinct = rs.randn(16, 1, cfg.d_model).astype(np.float32)
    for x in (same, distinct):
        jo, ja = jl.moe_layer(jp, jcfg, jnp.asarray(x), capacity_factor=1.25)
        to, ta = tl.moe_layer(tp, cfg, torch.from_numpy(x),
                              capacity_factor=1.25)
        np.testing.assert_allclose(to_np(to), to_np(jo), **MOE_TOL)
        np.testing.assert_allclose(float(ta), float(ja), **MOE_TOL)
        assert ((to_np(to) == 0).all(-1) == (to_np(jo) == 0).all(-1)).all()
    zero = (to_np(to) == 0).all(axis=(1, 2))
    assert not zero.any()   # distinct lanes: some pairs dropped, not all
    jo, _ = jl.moe_layer(jp, jcfg, jnp.asarray(same), capacity_factor=1.25)
    to, _ = tl.moe_layer(tp, cfg, torch.from_numpy(same),
                         capacity_factor=1.25)
    for out in (to_np(to), to_np(jo)):
        assert (out[10:] == 0).all() and (np.abs(out[:10]) > 0).any(-1).all()
        np.testing.assert_array_equal(out[:10], np.repeat(out[:1], 10, 0))
    # factor 8.0 on the same lanes drops nothing
    to8, _ = tl.moe_layer(tp, cfg, torch.from_numpy(same))
    np.testing.assert_allclose(to_np(to8), np.repeat(to_np(to)[:1], 16, 0),
                               **MOE_TOL)


def test_moe_top_k_ties_break_to_the_lower_index(setup):
    """A zero router gives every expert the same gate: both packages pick
    experts 0 and 1, as ``jax.lax.top_k`` breaks ties."""
    x = np.asarray([[3.0, 1.0, 3.0, 2.0, 3.0], [0.5] * 5], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tl._top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jp, tp = _moe(setup)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.RandomState(2).randn(1, 12, setup["cfg"].d_model) \
        .astype(np.float32)
    jo, _ = jl.moe_layer(jp, setup["jcfg"], jnp.asarray(x),
                         capacity_factor=1.25)
    to, _ = tl.moe_layer(tp, setup["cfg"], torch.from_numpy(x),
                         capacity_factor=1.25)
    np.testing.assert_allclose(to_np(to), to_np(jo), **MOE_TOL)


def test_moe_group_chunks_give_the_same_numbers(setup, monkeypatch):
    """T = 2048 tokens make two groups of 1024; with ``MOE_CHUNK_TOKENS``
    at 1024 the groups run one chunk at a time (the JAX package's chunk
    scan), with the numbers of one pass and of the JAX package's."""
    jp, tp = _moe(setup)
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    x = np.random.RandomState(3).randn(2, 1024, cfg.d_model) \
        .astype(np.float32)
    whole, _ = tl.moe_layer(tp, cfg, torch.from_numpy(x),
                            capacity_factor=1.25)
    monkeypatch.setattr(tl, "MOE_CHUNK_TOKENS", 1024)
    monkeypatch.setattr(jl, "MOE_CHUNK_TOKENS", 1024)
    chunked, _ = tl.moe_layer(tp, cfg, torch.from_numpy(x),
                              capacity_factor=1.25)
    jo, _ = jl.moe_layer(jp, jcfg, jnp.asarray(x), capacity_factor=1.25)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(chunked), to_np(jo), **MOE_TOL)


# ---------------------------------------------------------------------------
# the model's functions
# ---------------------------------------------------------------------------

def test_forward_full_matches_jax(setup):
    """S = 24 over an 8-token window: logits, hidden states and the summed
    aux loss, dense and through the flash wrapper (its plain version
    here), at 1e-4; the window bites (a windowless forward differs)."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    toks = _tokens(2, 24, 0, cfg.vocab_size)
    jo = jm.forward_full(jp, jcfg, jnp.asarray(toks))
    for use_kernel in (False, True):
        to = tm.forward_full(tp, cfg, torch.from_numpy(toks),
                             use_kernel=use_kernel)
        for key in ("logits", "hidden"):
            np.testing.assert_allclose(to_np(to[key]), to_np(jo[key]),
                                       **TOL)
        np.testing.assert_allclose(float(to["aux_loss"]),
                                   float(jo["aux_loss"]), **MOE_TOL)
    assert float(to["aux_loss"]) > 0
    wide = tm.forward_full(tp, dataclasses.replace(cfg, sliding_window=None),
                           torch.from_numpy(toks))
    assert np.abs(to_np(wide["logits"]) - to_np(to["logits"]))[:, WINDOW:] \
        .max() > 1e-2


def _prefill(s, toks, S, kv_dtype="f32"):
    """forward_full(return_kv) of ``toks[:, :S]`` written into fresh
    pools of both packages: (jax cache, torch cache)."""
    jcfg, cfg = s["jcfg"], s["cfg"]
    B = toks.shape[0]
    jo = jm.forward_full(s["jp"], jcfg, jnp.asarray(toks[:, :S]),
                         return_kv=True)
    to = tm.forward_full(s["tp"], cfg, torch.from_numpy(toks[:, :S]),
                         return_kv=True)
    jc = jm.write_prefill_kv(
        jcfg, jm.init_decode_cache(jcfg, B, CAP, kv_dtype=kv_dtype),
        jo["kvs"], jnp.full((B,), S, jnp.int32))
    tc = tm.write_prefill_kv(
        cfg, tm.init_decode_cache(cfg, B, CAP, kv_dtype=kv_dtype,
                                  device="cpu"),
        to["kvs"], torch.full((B,), S, dtype=torch.int32))
    return jc, tc


def test_decode_steps_match_jax(setup):
    """Three decode steps after a 16-token prefill (the window bites in the
    prefill's K/V), dense and kernel wrappers in turn: logits and the
    pools at 1e-4."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    B, S = 2, 16
    toks = _tokens(B, S + 3, 1, cfg.vocab_size)
    jc, tc = _prefill(setup, toks, S)
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


@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_prefill_chunk_step_matches_jax(setup, factor):
    """Two prompts of 13 and 20 tokens prefilled in chunks of 8 (the last
    chunk of each padded) over an 8-token window, the port's dense path
    and kernel wrapper against the JAX dense path: logits of the valid
    slots and the pools at 1e-4. At factor 1.25 an expert takes
    int(1.25 * 16 * 2 / 4) = 10 of a chunk's 32 pairs, the padded slots'
    too, as in the JAX package."""
    s = _with(setup, moe_capacity_factor=factor)
    jcfg, cfg, jp, tp = s["jcfg"], s["cfg"], s["jp"], s["tp"]
    B, C, lens = 2, 8, np.asarray([13, 20])
    toks = _tokens(B, 24, 2, cfg.vocab_size)
    bp = CAP // cfg.kv_block_size
    bt = (1 + np.arange(B * bp, dtype=np.int32)).reshape(B, bp)
    outs = {}
    for use_kernel in (False, True):
        jc = {**jm.init_decode_cache(jcfg, B, CAP, num_blocks=B * bp + 1,
                                     kv_dtype="f32"),
              "block_tables": jnp.asarray(bt)}
        tc = {**tm.init_decode_cache(cfg, B, CAP, num_blocks=B * bp + 1,
                                     kv_dtype="f32", device="cpu"),
              "block_tables": torch.from_numpy(bt)}
        logits = []
        for start in range(0, 24, C):
            pos = (start + np.arange(C, dtype=np.int32))[None].repeat(B, 0)
            valid = pos < lens[:, None]
            args = (toks[:, start:start + C], pos, valid)
            jo = jm.prefill_chunk_step(jp, jcfg, *map(jnp.asarray, args), jc,
                                       window_len=CAP)
            to = tm.prefill_chunk_step(tp, cfg,
                                       *map(torch.from_numpy, args), tc,
                                       window_len=CAP, use_kernel=use_kernel)
            jc = {**jo["cache"], "block_tables": jnp.asarray(bt)}
            np.testing.assert_allclose(to_np(to["logits"])[valid],
                                       to_np(jo["logits"])[valid], **TOL)
            logits.append(to["logits"])
        for k in ("k_pool", "v_pool"):
            np.testing.assert_allclose(to_np(tc[k])[:, 1:],
                                       to_np(jc[k])[:, 1:], **TOL)
        outs[use_kernel] = torch.cat(logits, dim=1)
    # on the CPU the kernel wrapper runs the plain version: same numbers
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


def test_lm_loss_includes_the_aux_loss(setup):
    """``lm_loss`` equals the JAX one (NLL plus 0.01 times the summed aux
    loss), and the aux term is what separates it from ``aux_weight=0``."""
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
    assert float(aux) > 0
    np.testing.assert_allclose(float(got - bare), 0.01 * float(aux),
                               rtol=1e-4)


def test_decode_window_quirk_in_both_packages(setup):
    """The reference quirk the port mirrors (ROADMAP C): the decode step
    masks by the engine's capacity (``window_len``), not by
    ``cfg.sliding_window``. Decoding 14 tokens one at a time from an empty
    cache gives, in both packages, the windowless forward's logits, and
    not the windowed forward's from position 8 on."""
    jcfg, cfg, jp, tp = setup["jcfg"], setup["cfg"], setup["jp"], setup["tp"]
    S = 14
    toks = _tokens(1, S, 5, cfg.vocab_size)
    jc = jm.init_decode_cache(jcfg, 1, CAP, kv_dtype="f32")
    tc = tm.init_decode_cache(cfg, 1, CAP, kv_dtype="f32", device="cpu")
    j_step = jax.jit(jm.decode_step, static_argnums=(1,),
                     static_argnames=("window_len",))
    jd, td = [], []
    for t in range(S):
        nt, pos = toks[:, t:t + 1], np.full((1,), t, np.int32)
        jo = j_step(jp, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                    window_len=CAP)
        to = tm.decode_step(tp, cfg, torch.from_numpy(nt),
                            torch.from_numpy(pos), tc, window_len=CAP,
                            use_kernel=True)
        jc, tc = jo["cache"], to["cache"]
        jd.append(to_np(jo["logits"])[0])
        td.append(to_np(to["logits"])[0])
    jd, td = np.stack(jd), np.stack(td)
    np.testing.assert_allclose(td, jd, **TOL)
    wide = tm.forward_full(tp, dataclasses.replace(cfg, sliding_window=None),
                           torch.from_numpy(toks))
    windowed = tm.forward_full(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(td, to_np(wide["logits"])[0], **TOL)
    np.testing.assert_allclose(td[:WINDOW], to_np(windowed["logits"])[0,
                                                                      :WINDOW],
                               **TOL)
    assert np.abs(td[WINDOW:] - to_np(windowed["logits"])[0, WINDOW:]) \
        .max(axis=-1).min() > 1e-3


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _serve_kw(kv_dtype, **kw):
    return dict(dict(max_batch=8, num_blocks=12, capacity=128,
                     max_new_tokens=24, use_kernel=False, faults=None,
                     kv_dtype=kv_dtype, prefix_cache=True, decode_horizon=4,
                     prefill_chunk_size=8), **kw)


def _serve_counting_drops(s, kw, monkeypatch):
    """Serve ``s``'s prompts (4 traces each, STEP) in both packages, the
    port through its kernel wrappers (their plain versions here). Returns
    (the port's engine, both results, the pairs that the expert capacity
    dropped in the one-shot prefills and in every other MoE call)."""
    _, jres = serve_jax(s, "step", s["prompts"], 4, **kw)
    dropped = {"one_shot": 0, "other": 0}
    phase = {"now": "other"}
    groups, forward = tl._moe_groups, te.forward_full

    def counting(pe, xg, sel, w, E, capacity, **kw):
        dropped[phase["now"]] += int(
            (~tl.moe_queue(sel, E, capacity)[2]).sum())
        return groups(pe, xg, sel, w, E, capacity, **kw)

    def one_shot(*args, **kwargs):
        phase["now"] = "one_shot"
        try:
            return forward(*args, **kwargs)
        finally:
            phase["now"] = "other"

    monkeypatch.setattr(tl, "_moe_groups", counting)
    monkeypatch.setattr(te, "forward_full", one_shot)
    eng, tres = serve_torch(s, "step", s["prompts"], 4,
                            **dict(kw, use_kernel=True))
    return eng, jres, tres, dropped


@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_greedy_serve_matches_jax(setup, factor, monkeypatch):
    """STEP over 4 traces of two prompts (longer than the window) with
    chunked prefill and the prefix cache, a pool tight enough to prune,
    an f32 pool: the port through its kernel wrappers (their plain
    versions here) equals the JAX engine's dense path. At factor 1.25
    an expert takes 5 of a decode iteration's 16 pairs (8 lanes, frozen
    and dead ones included): the serve drops pairs."""
    s = _with(setup, moe_capacity_factor=factor)
    eng, jres, tres, dropped = _serve_counting_drops(s, _serve_kw("f32"),
                                                     monkeypatch)
    assert eng.fused_scorer and eng.prefix_cache is not None
    assert sum(r.num_pruned for r in tres) > 0
    assert (sum(dropped.values()) > 0) == (factor == 1.25)
    assert_same_results(jres, tres)


@pytest.mark.parametrize("factor", [8.0, 1.25])
def test_one_shot_prefill_serve_matches_jax(setup, factor, monkeypatch):
    """The same serve with one-shot prefill (no chunks, no prefix cache),
    as the full-width serve runs: each prompt's S tokens route as one
    group of S, whose capacity int(cf * S * K / E) differs from a chunk's.
    At factor 1.25 the one-shot prefills themselves drop pairs, and the
    port still equals the JAX engine."""
    s = _with(setup, moe_capacity_factor=factor)
    kw = _serve_kw("f32", prefill_chunk_size=None, prefix_cache=False)
    eng, jres, tres, dropped = _serve_counting_drops(s, kw, monkeypatch)
    assert eng.prefix_cache is None and eng.ecfg.prefill_chunk_size is None
    assert (dropped["one_shot"] > 0) == (factor == 1.25)
    assert_same_results(jres, tres)


def test_int8_pool_serve_matches_jax(setup):
    """The same serve over an int8 pool (K1c's faces on the card)."""
    kw = _serve_kw("int8")
    _, jres = serve_jax(setup, "step", setup["prompts"], 4, **kw)
    _, tres = serve_torch(setup, "step", setup["prompts"], 4,
                          **dict(kw, use_kernel=True))
    assert_same_results(jres, tres)


def test_engine_gates_follow_the_matrix(setup):
    """mixtral gets every serving feature of the dense archs: chunked
    prefill, the prefix cache and int8/fp8 pools; mesh serving raises,
    as the JAX engine refuses MoE on a mesh."""
    cfg, tp = setup["cfg"], setup["tp"]
    assert tm.supports_chunked_prefill(cfg)
    for kv_dtype in ("int8", "fp8"):
        eng = te.Engine(tp, cfg, te.EngineConfig(**_serve_kw(kv_dtype)),
                        make_policy("step"), device="cpu")
        assert eng._chunk_supported and eng.prefix_cache is not None
    with pytest.raises(NotImplementedError, match="mesh"):
        te.Engine(tp, cfg, te.EngineConfig(**_serve_kw("bf16")),
                  make_policy("step"), mesh=object(), device="cpu")
