"""The launchers' step functions in the port against the JAX package's
(``repro.launch.steps``), and the model pieces they lower:

- ``make_train_step`` on bridged f32 smoke params and one batch, with 1,
  2 and 4 microbatches and with bf16 moments and accumulator: the loss
  and the updated params within 1e-4 (the gradients sum in another
  order; at lr 1e-4 an AdamW step moves a param by at most about lr);
- the three cases of ``tests/test_train_steps.py``, in the port;
- ``remat=True`` against ``remat=False``: the same loss and gradients
  (1e-6) for every stack shape (dense, MoE with its aux loss, MLA, ssm,
  the hybrid's groups, the encoder-decoder);
- ``make_prefill_step`` then ``make_decode_step`` (``serve_decode_step``
  over the contiguous caches) against JAX's prefill and
  ``serve_decode_step`` for 8 steps past a ring buffer's wrap, for the
  smoke configs of six archs: logits and hidden within f32 1e-4 at every
  step, the greedy tokens equal.
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

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.data.dataset import lm_batches  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro_torch.configs.registry import (get_config, kv_cache_specs,  # noqa: E402
                                          serving_config)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from torch_parity import to_np  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
REMAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _f32(jp):
    return jax.tree.map(lambda x: x.astype(jnp.float32), jp)


def _bridge(jp):
    return params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = j_serving_config(), serving_config()
    jp = _f32(j_init_params(jcfg, jax.random.PRNGKey(0)))
    arr = next(lm_batches(32, 8, seed=4))
    return jcfg, cfg, jp, arr


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches,dtype", [
    (1, "float32"), (2, "float32"), (4, "float32"), (2, "bfloat16")])
def test_train_step_matches_jax(lm, microbatches, dtype):
    jcfg, cfg, jp, arr = lm
    kw = dict(lr=1e-4, microbatches=microbatches, moment_dtype=dtype,
              accum_dtype=dtype)
    jstep, jopt = jsteps.make_train_step(jcfg, **kw)
    jbatch = {"tokens": jnp.asarray(arr[:, :-1]),
              "labels": jnp.asarray(arr[:, 1:])}
    jparams, _, jloss = jax.jit(jstep)(jp, jopt.init(jp), jbatch)
    tstep, topt = tsteps.make_train_step(cfg, **kw)
    tp = _bridge(jp)
    tok = torch.from_numpy(arr)
    tp, ts, tloss = tstep(tp, topt.init(tp),
                          {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    assert ts.step == 1
    assert not any(p.requires_grad for p in T.leaves(tp))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    got = [to_np(x) for x in T.leaves(tp)]
    want = [to_np(x) for x in jax.tree_util.tree_leaves(jparams)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_train_step_rejects_uneven_split(lm):
    _, cfg, jp, arr = lm
    step, opt = tsteps.make_train_step(cfg, microbatches=3)
    tp = _bridge(jp)
    tok = torch.from_numpy(arr)
    with pytest.raises(ValueError, match="does not split"):
        step(tp, opt.init(tp), {"tokens": tok[:, :-1], "labels": tok[:, 1:]})


# the cases of tests/test_train_steps.py, in the port

@pytest.fixture(scope="module")
def setup():
    cfg = serving_config()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 64),
                                     generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (8, 64),
                                     generator=g, dtype=torch.int32)}
    return cfg, params, batch


def _copy(params):
    return T.map_tree(torch.clone, params)


def test_microbatch_equals_full_batch_loss(setup):
    """mean microbatch loss == full-batch loss (same data, fixed params)."""
    cfg, params, batch = setup
    step1, opt1 = tsteps.make_train_step(cfg, lr=0.0)  # lr=0: no change
    step2, opt2 = tsteps.make_train_step(cfg, lr=0.0, microbatches=2)
    p1, p2 = _copy(params), _copy(params)
    _, _, loss1 = step1(p1, opt1.init(p1), batch)
    _, _, loss2 = step2(p2, opt2.init(p2), batch)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=2e-2,
                               atol=2e-2)


def test_microbatch_updates_close_to_full(setup):
    """One real update step: accumulated grads ~ full-batch grads."""
    cfg, params, batch = setup
    step1, opt1 = tsteps.make_train_step(cfg, lr=1e-3)
    step2, opt2 = tsteps.make_train_step(cfg, lr=1e-3, microbatches=4)
    p1, p2 = _copy(params), _copy(params)
    p1, _, _ = step1(p1, opt1.init(p1), batch)
    p2, _, _ = step2(p2, opt2.init(p2), batch)
    for a, b in zip(T.leaves(p1), T.leaves(p2)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0.1, atol=1e-2)


def test_bf16_moments_still_learn(setup):
    cfg, params, batch = setup
    step, opt = tsteps.make_train_step(cfg, lr=1e-3, moment_dtype="bfloat16",
                                       accum_dtype="bfloat16",
                                       microbatches=2)
    p = _copy(params)
    state = opt.init(p)
    assert all(x.dtype == torch.bfloat16 for x in T.leaves(state.mu))
    losses = []
    for _ in range(4):
        p, state, loss = step(p, state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(l) for l in losses)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

ARCHS = ("qwen3-4b-thinking", "mixtral-8x7b", "deepseek-v2-236b",
         "mamba2-2.7b", "zamba2-2.7b", "seamless-m4t-large-v2")


def smoke(get, arch):
    """``arch``'s smoke config from ``get`` (either package's registry);
    zamba2's with two groups of two Mamba2 layers, so that a group's
    states or caches read in another group's place would show."""
    cfg = get(arch, smoke=True)
    if cfg.arch_type == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=2 * cfg.hybrid_attn_every)
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_plain(arch):
    """Checkpointed layers give the loss and gradients of the plain
    forward: the MoE's aux loss leaves its checkpointed layer, and the
    router, which only the gates and the aux loss reach, gets the same
    gradient."""
    cfg = smoke(get_config, arch)
    params = T.map_tree(lambda x: x.float(),
                        init_params(cfg, torch.Generator().manual_seed(2)))
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["encoder_embeds"] = 0.02 * torch.randn(
            2, cfg.encoder_seq_len, cfg.d_model, generator=g)
    leaves = T.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for remat in (False, True):
        loss = tm.lm_loss(params, cfg, tokens[:, :-1], tokens[:, 1:],
                          remat=remat, **kw)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    if cfg.uses_moe:
        with torch.no_grad():
            assert float(tm.forward_full(params, cfg, tokens)["aux_loss"]) > 0
    torch.testing.assert_close(out[True][0], out[False][0], **REMAT_TOL)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, **REMAT_TOL)


# ---------------------------------------------------------------------------
# prefill + contiguous-cache decode
# ---------------------------------------------------------------------------

B, PROMPT, CAP, STEPS = 2, 12, 16, 8   # positions 12..19 wrap the ring


def _jax_cache(jcfg, kvs, jp, enc):
    """JAX's contiguous cache from its prefill: the prompt's K/V at slots
    0..PROMPT-1 of a CAP-slot ring (f32), or the ssm end state."""
    def ring(x):   # [L, B, S, ...] -> [L, B, CAP, ...]
        pad = [(0, 0)] * x.ndim
        pad[2] = (0, CAP - x.shape[2])
        return jnp.pad(x, pad)

    if jcfg.arch_type == "ssm":
        return {"ssm_state": kvs[0], "conv_state": kvs[1]}
    cache = {}
    if jcfg.arch_type == "hybrid":
        (ss, cs), kvs = kvs
        cache["ssm_state"] = ss.reshape(-1, *ss.shape[2:])
        cache["conv_state"] = cs.reshape(-1, *cs.shape[2:])
    if jcfg.use_mla:
        cache["kv_cache"] = ring(kvs)
    else:
        cache["k_cache"], cache["v_cache"] = ring(kvs[0]), ring(kvs[1])
    if jcfg.is_encoder_decoder:
        cache["cross_k"], cache["cross_v"] = jm.build_cross_cache(
            jp, jcfg, jm.encode(jp, jcfg, enc))
    return cache


def _torch_cache(cfg, kvs, tp, enc):
    """The port's: zeros laid out as kv_cache_specs lays out decode_32k,
    at B lanes and a CAP-slot ring (in f32), seeded by
    write_contiguous_kv."""
    cache = {}
    for key, spec in kv_cache_specs(cfg, "decode_32k").items():
        shape = [spec.shape[0], B, *spec.shape[2:]]
        if key in ("k_cache", "v_cache", "kv_cache"):
            shape[2] = CAP
        if key not in ("cross_k", "cross_v"):
            cache[key] = torch.zeros(shape)
    tm.write_contiguous_kv(cfg, cache, kvs)
    if cfg.is_encoder_decoder:
        cache["cross_k"], cache["cross_v"] = tm.build_cross_cache(
            tp, cfg, tm.encode(tp, cfg, enc))
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    jcfg, cfg = smoke(j_get_config, arch), smoke(get_config, arch)
    jp = _f32(j_init_params(jcfg, jax.random.PRNGKey(5)))
    tp = _bridge(jp)
    rs = np.random.RandomState(6)
    prompt = rs.randint(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    batch_j, batch_t = ({"tokens": jnp.asarray(prompt)},
                        {"tokens": torch.from_numpy(prompt)})
    enc = None
    if cfg.is_encoder_decoder:
        enc = (0.02 * rs.randn(B, cfg.encoder_seq_len, cfg.d_model)
               ).astype(np.float32)
        batch_j["encoder_embeds"] = jnp.asarray(enc)
        batch_t["encoder_embeds"] = enc = torch.from_numpy(enc)
    jpre = jax.jit(jsteps.make_prefill_step(jcfg))(jp, batch_j)
    tpre = tsteps.make_prefill_step(cfg)(tp, batch_t)
    np.testing.assert_allclose(to_np(tpre["next_logits"]),
                               to_np(jpre["next_logits"]), **TOL)
    jcache = _jax_cache(jcfg, jpre["kvs"], jp, batch_j.get("encoder_embeds"))
    tcache = _torch_cache(cfg, tpre["kvs"], tp, enc)

    jdecode = jax.jit(jm.serve_decode_step, static_argnums=1)
    tdecode = tsteps.make_decode_step(cfg)
    tok = np.array(jnp.argmax(jpre["next_logits"], -1), np.int32)
    for i in range(STEPS):
        pos = np.full((B,), PROMPT + i, np.int32)
        jout = jdecode(jp, jcfg, jnp.asarray(tok[:, None]),
                       jnp.asarray(pos), jcache)
        tout = tdecode(tp, {"tokens": torch.from_numpy(tok[:, None]),
                            "positions": torch.from_numpy(pos)}, tcache)
        np.testing.assert_allclose(to_np(tout["logits"]),
                                   to_np(jout["logits"]), **TOL)
        np.testing.assert_allclose(to_np(tout["hidden"]),
                                   to_np(jout["hidden"]), **TOL)
        jtok = np.array(jnp.argmax(jout["logits"], -1), np.int32)
        assert tout["next_token"].dtype == torch.int32
        np.testing.assert_array_equal(tout["next_token"].numpy(), jtok)
        assert all(tout["cache"][k] is v for k, v in tcache.items())
        jcache, tok = jout["cache"], jtok
    for key, val in tcache.items():
        np.testing.assert_allclose(to_np(val), to_np(jcache[key]), **TOL)


def test_write_contiguous_kv_rejects_long_prompt():
    cfg = get_config("qwen3-4b-thinking", smoke=True)
    cache = {k: torch.zeros(2, 1, 4, cfg.num_kv_heads, cfg.head_dim)
             for k in ("k_cache", "v_cache")}
    kv = torch.ones(2, 1, 5, cfg.num_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="does not fit"):
        tm.write_contiguous_kv(cfg, cache, (kv, kv))
