"""The port's mamba2-2.7b stack against the JAX package at the smoke
config: the config and param layout, the Mamba2 block's functions,
``forward_full`` (dense and through the SSD scan wrapper), decode,
``lm_loss``, and the decode horizon's treatment of a stopped lane's
recurrent state.

Tolerances: f32 params throughout. The block's functions at 1e-5
relative plus 1e-5 absolute (the same f32 arithmetic, contracted in
another order); the model's logits and states at 1e-4, as
``tests/test_torch_model.py`` holds the dense f32 forward (two layers of
the mixer, each with an f32 matmul over d_model and the chunked scan).
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
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.init import init_params, padded_vocab  # noqa: E402
from torch_parity import pair, to_np  # noqa: E402

ARCH = "mamba2-2.7b"
BLOCK = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = j_registry.get_config(ARCH, smoke=True)
    cfg = t_registry.get_config(ARCH, smoke=True)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      j_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, params_from_numpy(jax.device_get(jp),
                                            device="cpu")


def _layer(jp, tp, l=0):
    """Layer ``l``'s mixer params in both packages."""
    return (jax.tree.map(lambda x: x[l], jp["layers"]["mixer"]),
            {k: v[l] for k, v in tp["layers"]["mixer"].items()})


def _tokens(seed, B, S, V):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# config and params
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    for smoke in (False, True):
        assert t_registry.get_config(ARCH, smoke).__dict__ == \
            j_registry.get_config(ARCH, smoke).__dict__
    assert t_registry.serving_config(ARCH).__dict__ == \
        j_registry.serving_config(ARCH).__dict__
    full = t_registry.get_config(ARCH)
    assert (full.d_inner, full.ssm_heads, padded_vocab(full)) == \
        (5120, 80, 50432)


def test_params_layout_matches_jax_and_the_bridge(models):
    """The port's own init, the JAX init and the bridged JAX tree have the
    same names, shapes and dtypes (bf16 matrices, f32 A_log/D/dt_bias),
    and the deterministic leaves the same values (to one f32 ulp of the
    two libraries' log)."""
    jcfg, cfg, _, _ = models
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    bridged = params_from_numpy(jax.device_get(jp), device="cpu")
    own = init_params(cfg, torch.Generator().manual_seed(0))

    def layout(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(layout(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = (tuple(v.shape), str(v.dtype)
                                   .replace("torch.", ""))
        return out

    assert layout(own) == layout(bridged) == layout(jp)
    for key in ("A_log", "D", "dt_bias", "norm_w", "conv_b"):
        np.testing.assert_allclose(
            own["layers"]["mixer"][key].float().numpy(),
            np.asarray(jp["layers"]["mixer"][key], np.float32),
            rtol=2e-7, atol=0)


def test_unported_stacks_still_raise(models):
    """MoE, MLA and enc-dec stacks raise naming ROADMAP A9; the chunked
    prefill step stays the dense stack's, as in the JAX package."""
    _, cfg, _, tp = models
    for bad in (dataclasses.replace(cfg, is_encoder_decoder=True),
                dataclasses.replace(cfg, arch_type="moe", num_experts=4),
                dataclasses.replace(cfg, use_mla=True)):
        with pytest.raises(NotImplementedError, match="A9"):
            init_params(bad, torch.Generator().manual_seed(0))
        with pytest.raises(NotImplementedError, match="A9"):
            tm.forward_full(tp, bad, torch.zeros((1, 4), dtype=torch.int32))
    assert not tm.supports_chunked_prefill(cfg)
    with pytest.raises(NotImplementedError, match="dense GQA"):
        tm.prefill_chunk_step(tp, cfg, torch.zeros((1, 4), dtype=torch.int32),
                              torch.zeros((1, 4), dtype=torch.int32),
                              torch.ones((1, 4), dtype=torch.bool), {}, 64)
    with pytest.raises(KeyError, match="A9"):
        t_registry.get_config("mixtral-8x7b")


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def test_ssd_decode_step_matches_jax():
    rs = np.random.RandomState(0)
    B, H, P, N = 3, 4, 8, 16
    arrs = [rs.randn(B, H, P, N), rs.randn(B, H, P),
            np.log1p(np.exp(rs.randn(B, H))), -np.exp(rs.randn(H)),
            rs.randn(B, N), rs.randn(B, N)]
    pairs = [pair(a.astype(np.float32)) for a in arrs]
    yj, sj = jl.ssd_decode_step(*[p[0] for p in pairs])
    yt, st = tl.ssd_decode_step(*[p[1] for p in pairs])
    np.testing.assert_allclose(to_np(yt), to_np(yj), **BLOCK)
    np.testing.assert_allclose(to_np(st), to_np(sj), **BLOCK)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_matches_jax(dt):
    """Full-sequence and one-step depthwise causal conv; bf16 at 1e-2
    (one bf16 ulp of the output)."""
    rs = np.random.RandomState(1)
    B, S, C, W = 2, 9, 24, 4
    tol = BLOCK if dt == "f32" else dict(rtol=1e-2, atol=1e-2)
    x, w, b = (pair(a.astype(np.float32), dt)
               for a in (rs.randn(B, S, C), rs.randn(W, C), rs.randn(C)))
    np.testing.assert_allclose(to_np(tl.causal_conv1d(x[1], w[1], b[1])),
                               to_np(jl.causal_conv1d(x[0], w[0], b[0])),
                               **tol)
    state = pair(rs.randn(B, W - 1, C).astype(np.float32), dt)
    yj, nj = jl.causal_conv1d_step(state[0], x[0][:, 0], w[0], b[0])
    yt, nt = tl.causal_conv1d_step(state[1], x[1][:, 0], w[1], b[1])
    np.testing.assert_allclose(to_np(yt), to_np(yj), **tol)
    np.testing.assert_allclose(to_np(nt), to_np(nj), **tol)
    assert nt.dtype == state[1].dtype


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [33, 20, 64])
def test_mixer_full_matches_jax(models, S, use_kernel):
    """S = 33 pads to 64 (two chunks of 32, the second with 31 zero
    steps); S = 20 is one chunk of 20; S = 64 two full chunks. Through the
    scan wrapper (its plain version here) against the interpret-mode
    Pallas kernel, with the end state for decode continuation."""
    jcfg, cfg, jp, tp = models
    jlp, tlp = _layer(jp, tp)
    x = np.random.RandomState(2).randn(2, S, cfg.d_model).astype(np.float32)
    xj, xt = pair(x)
    oj, sj, cj = jl.mamba2_mixer_full(jlp, jcfg, xj, use_kernel=use_kernel,
                                      return_state=True)
    ot, st, ct = tl.mamba2_mixer_full(tlp, cfg, xt, use_kernel=use_kernel,
                                      return_state=True)
    tol = dict(rtol=1e-4, atol=1e-4) if use_kernel else BLOCK
    np.testing.assert_allclose(to_np(ot), to_np(oj), **tol)
    np.testing.assert_allclose(to_np(st), to_np(sj), **tol)
    np.testing.assert_allclose(to_np(ct), to_np(cj), **BLOCK)
    assert st.dtype == torch.float32 and ct.shape == (2, 3, cfg.d_inner
                                                      + 2 * cfg.ssm_state_size)
    np.testing.assert_allclose(
        to_np(tl.mamba2_mixer_full(tlp, cfg, xt, use_kernel=use_kernel)),
        to_np(ot), rtol=0, atol=0)


def test_mixer_decode_matches_jax(models):
    jcfg, cfg, jp, tp = models
    jlp, tlp = _layer(jp, tp, 1)
    rs = np.random.RandomState(3)
    B, H, P, N = 3, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_size
    x = pair(rs.randn(B, 1, cfg.d_model).astype(np.float32))
    ss = pair(rs.randn(B, H, P, N).astype(np.float32))
    cs = pair(rs.randn(B, cfg.ssm_conv_width - 1,
                       cfg.d_inner + 2 * N).astype(np.float32))
    oj, sj, cj = jl.mamba2_mixer_decode(jlp, jcfg, x[0], ss[0], cs[0])
    ot, st, ct = tl.mamba2_mixer_decode(tlp, cfg, x[1], ss[1], cs[1])
    for got, want in ((ot, oj), (st, sj), (ct, cj)):
        np.testing.assert_allclose(to_np(got), to_np(want), **BLOCK)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_full_matches_jax(models, use_kernel):
    """Logits, hidden and the end state (ssm_state [L, B, H, P, N] f32,
    conv_state [L, B, W-1, di+2N]) on bridged f32 params, S = 45 (pads to
    two chunks); ``use_kernel`` runs each layer's scan through the wrapper
    (the plain version here; the Pallas kernel in interpret mode in JAX),
    one call per layer."""
    jcfg, cfg, jp, tp = models
    toks = _tokens(4, 2, 45, cfg.vocab_size)
    want = jm.forward_full(jp, jcfg, jnp.asarray(toks), return_kv=True,
                           use_kernel=use_kernel)
    ops.reset_launch_counts()
    got = tm.forward_full(tp, cfg, torch.from_numpy(toks), return_kv=True,
                          use_kernel=use_kernel)
    assert ops.launch_counts()["ssd_scan"] == 0  # CPU: no kernel launch
    for key in ("logits", "hidden"):
        np.testing.assert_allclose(to_np(got[key]), to_np(want[key]),
                                   **MODEL)
    for g, w in zip(got["kvs"], want["kvs"]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(to_np(g), to_np(w), **MODEL)


def test_cache_layout_matches_jax(models):
    """No pools (no attention layer): f32 ssm_state and bf16 conv_state of
    the JAX package's shapes; the port keeps the block tables beside."""
    jcfg, cfg, _, _ = models
    jc = jm.init_decode_cache(jcfg, 3, 64)
    tc = tm.init_decode_cache(cfg, 3, 64, device="cpu")
    assert set(tc) == set(jc) | {"block_tables"}
    for key in ("ssm_state", "conv_state"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype).replace("torch.", "") == str(jc[key].dtype)
        assert not tc[key].any()


def test_decode_steps_match_forward_and_jax(models):
    """Prefill S tokens, then decode 4 more one at a time: each step's
    logits match the full forward over the same prefix (as
    tests/test_decode_consistency.py holds the JAX package) and the JAX
    package's decode step on the same weights; the state is written in
    place."""
    jcfg, cfg, jp, tp = models
    B, S = 2, 11
    toks = _tokens(5, B, S + 4, cfg.vocab_size)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jout = jm.forward_full(jp, jcfg, jt[:, :S], return_kv=True)
    tout = tm.forward_full(tp, cfg, tt[:, :S], return_kv=True)
    jcache = jm.write_prefill_kv(jcfg, jm.init_decode_cache(jcfg, B, 64),
                                 jout["kvs"], jnp.full((B,), S, jnp.int32))
    tcache = tm.write_prefill_kv(cfg, tm.init_decode_cache(cfg, B, 64,
                                                           device="cpu"),
                                 tout["kvs"], torch.full((B,), S))
    for i in range(4):
        pos = S + i
        js = jm.decode_step(jp, jcfg, jt[:, pos:pos + 1],
                            jnp.full((B,), pos, jnp.int32), jcache,
                            window_len=64)
        jcache = js["cache"]
        state = tcache["ssm_state"]
        ts = tm.decode_step(tp, cfg, tt[:, pos:pos + 1],
                            torch.full((B,), pos, dtype=torch.int32), tcache,
                            window_len=64)
        assert ts["cache"]["ssm_state"] is state   # written in place
        full = tm.forward_full(tp, cfg, tt[:, :pos + 1])["logits"][:, -1]
        np.testing.assert_allclose(to_np(ts["logits"]), to_np(full),
                                   **MODEL)
        np.testing.assert_allclose(to_np(ts["logits"]),
                                   to_np(js["logits"]), **MODEL)
        for key in ("ssm_state", "conv_state"):
            np.testing.assert_allclose(to_np(tcache[key]),
                                       to_np(jcache[key]), **MODEL)


def test_lm_loss_matches_jax(models):
    jcfg, cfg, jp, tp = models
    toks = _tokens(6, 2, 40, cfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -3:] = -1   # masked
    want = jm.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    got = tm.lm_loss(tp, cfg, torch.from_numpy(toks),
                     torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the decode horizon and a lane that its limit stopped
# ---------------------------------------------------------------------------

def _horizon(models, limits, horizon):
    """Prefill two lanes, then one fused horizon of greedy decode with
    per-lane ``limits``, in both packages. Returns (tokens, ssm_state)
    of each: (jax, torch)."""
    jcfg, cfg, jp, tp = models
    B, S, bp = 2, 9, 4
    toks = _tokens(7, B, S, cfg.vocab_size)
    jout = jm.forward_full(jp, jcfg, jnp.asarray(toks), return_kv=True)
    tout = tm.forward_full(tp, cfg, torch.from_numpy(toks), return_kv=True)
    jcache = jm.write_prefill_kv(jcfg, jm.init_decode_cache(jcfg, B, 64),
                                 jout["kvs"], jnp.full((B,), S, jnp.int32))
    jcache["block_tables"] = jnp.zeros((B, bp), jnp.int32)
    tcache = tm.write_prefill_kv(cfg, tm.init_decode_cache(cfg, B, 64,
                                                           device="cpu"),
                                 tout["kvs"], torch.full((B,), S))
    first = np.array(jnp.argmax(jout["logits"][:, -1], -1), np.int32)
    lim = np.asarray(limits, np.int32)
    common = dict(window_len=64, horizon=horizon, eos_id=-1, step_id=-1)
    jo = jm.multi_decode_step(
        jp, jcfg, jnp.asarray(first), jnp.full((B,), S, jnp.int32),
        jnp.asarray(lim), jcache,
        rng_keys=jnp.stack([jax.random.PRNGKey(0)] * horizon),
        sample_fn=lambda k, lg: (jnp.argmax(lg, -1).astype(jnp.int32),
                                 jnp.zeros(lg.shape[0])), **common)
    to = tm.multi_decode_step(
        tp, cfg, torch.from_numpy(first), torch.full((B,), S),
        torch.from_numpy(lim), tcache, rng=None,
        sample_fn=lambda g, lg: (lg.argmax(-1).to(torch.int32),
                                 torch.zeros(lg.shape[0])), **common)
    return ((np.asarray(jo["tokens"]), np.asarray(jo["cache"]["ssm_state"])),
            (to["tokens"].numpy(), to["cache"]["ssm_state"].numpy()))


def test_stopped_lane_state_drifts_in_both_packages(models):
    """A lane that its limit stops inside a horizon (memory contention,
    not EOS) keeps running, re-fed its last token, and nothing masks its
    recurrent state: at horizon 4 with limit 2 its ssm_state ends two
    steps past the state of its two emitted tokens. The paged archs send
    such writes to the scratch block; the ssm arch has no such guard. The
    port mirrors the JAX package (parity is the contract): the same
    tokens, the same drifted state."""
    (jt4, js4), (tt4, ts4) = _horizon(models, [4, 2], 4)
    (jt2, js2), (tt2, ts2) = _horizon(models, [4, 2], 2)
    np.testing.assert_array_equal(tt4, jt4)
    np.testing.assert_allclose(ts4, js4, **MODEL)
    np.testing.assert_allclose(ts2, js2, **MODEL)
    # lane 0 ran all its steps either way: its first two tokens agree
    np.testing.assert_array_equal(tt4[0, :2], tt2[0, :2])
    # lane 1 emitted the same two tokens, but its state moved on
    np.testing.assert_array_equal(tt4[1, :2], tt2[1, :2])
    for s4, s2 in ((js4, js2), (ts4, ts2)):
        assert np.abs(s4[:, 1] - s2[:, 1]).max() > 1e-3
