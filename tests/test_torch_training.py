"""LM training and step-scorer building in the port against the JAX
package: AdamW and the cosine schedule, one ``make_train_step`` on bridged
f32 weights, ``lm_batches``, the ``.npz`` checkpoints (each package loads
the other's), ``train_scorer`` from the same initial params, greedy
``generate_batch`` and the boundary hiddens of the pipeline.

Tolerances: the optimizer and the schedule at 1e-6 (f32 in both, the same
operations in the same order); the train step's loss and params at 1e-5
(the gradients sum in another order); the scorer's epoch losses at 1e-5;
hidden states at 1e-4, as ``tests/test_torch_model.py`` holds the f32
forward. Greedy tokens are identical.
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import random  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.core import pipeline as j_pipe  # noqa: E402
from repro.core import scorer as j_scorer  # noqa: E402
from repro.data import dataset as j_data  # noqa: E402
from repro.data.arithmetic import gen_problem, make_prompt  # noqa: E402
from repro.data.tokenizer import get_tokenizer  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving.sampling import sample_tokens as j_sample_tokens  # noqa: E402
from repro.training import checkpoint as j_ckpt  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import trainer as j_trainer  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core import pipeline as t_pipe  # noqa: E402
from repro_torch.core import scorer as t_scorer  # noqa: E402
from repro_torch.data import dataset as t_data  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.serving.sampling import sample_tokens as t_sample_tokens  # noqa: E402
from repro_torch.training import checkpoint as t_ckpt  # noqa: E402
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402
from repro_torch.training import tree as T  # noqa: E402
from torch_parity import to_np  # noqa: E402

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN_TOL = dict(rtol=1e-4, atol=1e-4)


def _tree_np(tree):
    """Either package's tree as a flat list of f32 numpy arrays."""
    if isinstance(tree, dict) and any(isinstance(x, torch.Tensor)
                                      for x in T.leaves(tree)):
        return [to_np(x.detach()) for x in T.leaves(tree)]
    return [to_np(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_trees_close(t_tree, j_tree, tol):
    got, want = _tree_np(t_tree), _tree_np(j_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = j_serving_config(), serving_config()
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      j_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp


def _bridge(jp):
    return params_from_numpy(jax.device_get(jp), device="cpu")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_adamw_matches_jax(moment_dtype, grad_clip):
    rs = np.random.RandomState(0)
    shapes = {"w": (6, 5), "blk": {"b": (5,), "a": (3, 2)}}
    params = jax.tree.map(lambda s: rs.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(learning_rate=j_opt.cosine_schedule(1e-2, 1, 5),
              weight_decay=0.01, grad_clip=grad_clip,
              moment_dtype=moment_dtype)
    jopt = j_opt.AdamW(**kw)
    topt = t_opt.AdamW(**dict(kw, learning_rate=t_opt.cosine_schedule(
        1e-2, 1, 5)))
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = jax.tree.map(lambda s: 3 * rs.randn(*s).astype(np.float32),
                             shapes, is_leaf=lambda x: isinstance(x, tuple))
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = topt.update(params_from_numpy(grads, device="cpu"), ts, tp)
    assert ts.step == int(js.step) == 3
    _assert_trees_close(tp, jp, OPT_TOL)
    _assert_trees_close(ts.mu, js.mu, OPT_TOL)
    _assert_trees_close(ts.nu, js.nu, OPT_TOL)
    assert T.leaves(ts.mu)[0].dtype == getattr(torch, moment_dtype)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_blocks_equal_whole_tensors(monkeypatch, moment_dtype):
    """Tensors past ``BLOCK_ELEMENTS`` are updated in blocks of leading
    rows: the same elementwise arithmetic, so the same bits as one
    whole-tensor update (scalars and tensors under the limit stay
    whole)."""
    rs = np.random.RandomState(4)
    shapes = {"w": (7, 5), "s": (3, 4, 2), "b": (9,), "c": ()}

    def run(block):
        monkeypatch.setattr(t_opt, "BLOCK_ELEMENTS", block)
        tp = params_from_numpy({k: np.asarray(rs.randn(*v), np.float32)
                                for k, v in shapes.items()}, device="cpu")
        opt = t_opt.AdamW(learning_rate=1e-2, weight_decay=0.01,
                          moment_dtype=moment_dtype)
        state = opt.init(tp)
        for _ in range(2):
            grads = T.map_tree(lambda x: torch.from_numpy(
                np.asarray(3 * rs.randn(*x.shape), np.float32)), tp)
            tp, state = opt.update(grads, state, tp)
        return T.leaves(tp) + T.leaves(state.mu) + T.leaves(state.nu)

    seed = rs.get_state()
    whole = run(2 ** 26)
    rs.set_state(seed)
    blocked = run(8)
    assert len(list(t_opt._blocks(torch.zeros(7, 5)))) == 7
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_cosine_schedule_matches_jax():
    jf, tf = j_opt.cosine_schedule(3e-3, 30, 300), \
        t_opt.cosine_schedule(3e-3, 30, 300)
    for step in list(range(0, 40)) + [100, 299, 300, 301, 500]:
        np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))),
                                   **OPT_TOL)


# ---------------------------------------------------------------------------
# training step, batches, checkpoints
# ---------------------------------------------------------------------------

def test_train_step_matches_jax(models):
    """The first AdamW step moves a param by about lr * g / (|g| + eps):
    where |g| is near eps, the gradients' summation order shows in the
    step at up to lr itself. A learning rate of 1e-4 keeps that under the
    1e-5 tolerance (at 1e-3, 2 of 131072 params differ by 2.3e-5)."""
    jcfg, cfg, jp = models
    arr = next(j_data.lm_batches(16, 2, seed=3))
    kw = dict(learning_rate=1e-4, weight_decay=0.01)
    jstep = j_trainer.make_train_step(jcfg, j_opt.AdamW(**kw))
    topt = t_opt.AdamW(**kw)
    tstep = t_trainer.make_train_step(cfg, topt)
    jparams = jax.tree.map(jnp.copy, jp)
    jparams, _, jloss = jstep(jparams, j_opt.AdamW(**kw).init(jparams),
                              jnp.asarray(arr[:, :-1]),
                              jnp.asarray(arr[:, 1:]))
    tp = _bridge(jp)
    tok = torch.from_numpy(arr)
    tp, ts, tloss = tstep(tp, topt.init(tp), tok[:, :-1], tok[:, 1:])
    assert ts.step == 1
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    _assert_trees_close(tp, jparams, STEP_TOL)


def test_chunked_ce_matches_plain(models):
    """The sequence-chunked loss (the one above 1024 tokens) sums what the
    one-shot loss sums."""
    _, cfg, jp = models
    tp = _bridge(jp)
    rs = np.random.RandomState(5)
    toks = torch.from_numpy(rs.randint(0, 25, (2, 64)).astype(np.int32))
    labels = torch.from_numpy(rs.randint(-1, 25, (2, 64)).astype(np.int32))
    with torch.no_grad():
        hidden = tm.forward_full(tp, cfg, toks)["hidden"]
        valid = (labels >= 0) & (labels < cfg.vocab_size)
        chunked = tm._chunked_ce(hidden, tp["embed"].T, labels, valid, 16)
        plain = tm.lm_loss(tp, cfg, toks, labels)
    np.testing.assert_allclose(float(chunked / valid.sum()), float(plain),
                               rtol=1e-6)


def test_lm_batches_identical():
    jb = j_data.lm_batches(48, 3, seed=7, corrupt_prob=0.3)
    tb = t_data.lm_batches(48, 3, seed=7, corrupt_prob=0.3)
    for _ in range(4):
        a, b = next(jb), next(tb)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng_j, rng_t, prob_rng = random.Random(2), random.Random(2), \
        random.Random(3)
    for _ in range(5):
        p = gen_problem(prob_rng)
        assert t_data.render_example(p, 0.5, rng_t) == \
            j_data.render_example(p, 0.5, rng_j)


def test_checkpoints_load_across_packages(tmp_path):
    """bf16 params saved by JAX load into the port, and back; both write
    the same leaves and the same structure record."""
    jcfg = j_serving_config()
    jp = j_init_params(jcfg, jax.random.PRNGKey(1))      # bf16 leaves
    tp = _bridge(jp)
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_ckpt.save_pytree(j_path, jp)
    t_ckpt.save_pytree(t_path, tp)
    like = T.map_tree(torch.zeros_like, tp)
    loaded_t = t_ckpt.load_pytree(j_path, like)
    loaded_j = j_ckpt.load_pytree(t_path, jax.tree.map(jnp.zeros_like, jp))
    for a, b in zip(T.leaves(loaded_t), T.leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(loaded_j),
                    jax.tree_util.tree_leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))
    jz, tz = np.load(j_path), np.load(t_path)
    assert sorted(jz.files) == sorted(tz.files)
    for name in jz.files:
        assert np.array_equal(jz[name], tz[name]), name
    with pytest.raises(ValueError, match="leaf 0"):
        t_ckpt.load_pytree(j_path, {"a": torch.zeros(3)})


# ---------------------------------------------------------------------------
# step scorer
# ---------------------------------------------------------------------------

def _scorer_data(seed, M=240, D=32):
    rs = np.random.RandomState(seed)
    y = (rs.rand(M) < 0.35).astype(np.int32)
    h = (rs.randn(M, D) + 0.6 * y[:, None]).astype(np.float32)
    return h, y


def test_train_scorer_matches_jax():
    h, y = _scorer_data(0)
    jinit = j_scorer.init_scorer(jax.random.PRNGKey(3), h.shape[1])
    cfg = dict(batch_size=32, max_epochs=4, learning_rate=3e-3)
    jparams, jinfo = j_scorer.train_scorer(
        h, y, j_scorer.ScorerTrainConfig(**cfg), params=jinit)
    tinit = scorer_from_numpy(jax.device_get(jinit), device="cpu")
    tparams, tinfo = t_scorer.train_scorer(
        h, y, t_scorer.ScorerTrainConfig(**cfg), params=tinit, device="cpu")
    assert tinfo["alpha"] == jinfo["alpha"]
    assert len(tinfo["history"]) == len(jinfo["history"])
    for te_, je_ in zip(tinfo["history"], jinfo["history"]):
        np.testing.assert_allclose(te_["train_loss"], je_["train_loss"],
                                   **STEP_TOL)
        np.testing.assert_allclose(te_["val_loss"], je_["val_loss"],
                                   **STEP_TOL)
    _assert_trees_close(tparams, jparams, STEP_TOL)
    # the caller's initial params are left as they were
    _assert_trees_close(tinit, jinit, dict(rtol=0, atol=0))
    scores = t_scorer.scorer_score(tparams, torch.from_numpy(h)).numpy()
    jscores = np.asarray(j_scorer.scorer_score(jparams, jnp.asarray(h)))
    assert t_scorer.rank_accuracy(scores[y == 1], scores[y == 0]) == \
        pytest.approx(j_scorer.rank_accuracy(jscores[y == 1],
                                             jscores[y == 0]), abs=1e-3)


def test_weighted_bce_and_early_stopping():
    """The loss matches the JAX package's; with a learning rate that
    overshoots, early stopping returns the best epoch, not the last."""
    h, y = _scorer_data(1, M=64)
    jp = j_scorer.init_scorer(jax.random.PRNGKey(4), h.shape[1])
    tp = scorer_from_numpy(jax.device_get(jp), device="cpu")
    np.testing.assert_allclose(
        float(t_scorer.weighted_bce_loss(tp, torch.from_numpy(h),
                                         torch.from_numpy(y), 1.7)),
        float(j_scorer.weighted_bce_loss(jp, jnp.asarray(h), jnp.asarray(y),
                                         1.7)), rtol=1e-6)
    cfg = dict(batch_size=16, max_epochs=12, patience=2, learning_rate=0.5)
    _, jinfo = j_scorer.train_scorer(h, y, j_scorer.ScorerTrainConfig(**cfg),
                                     params=jp)
    tparams, tinfo = t_scorer.train_scorer(
        h, y, t_scorer.ScorerTrainConfig(**cfg), params=tp, device="cpu")
    assert len(tinfo["history"]) == len(jinfo["history"])
    np.testing.assert_allclose(tinfo["best_val_loss"],
                               jinfo["best_val_loss"], **STEP_TOL)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def test_sample_tokens_greedy_matches_jax():
    logits = np.random.RandomState(6).randn(4, 40).astype(np.float32)
    jt, jc = j_sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits),
                             temperature=0.0, top_k=0, top_p=1.0)
    tt, tc = t_sample_tokens(None, torch.from_numpy(logits),
                             temperature=0.0, top_k=0, top_p=1.0)
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)


def test_generate_batch_greedy_matches_jax(models, monkeypatch):
    """The reference's ``generate_batch`` adds 1 to its numpy ``positions``
    in place right after handing ``jnp.asarray(positions)`` to an
    asynchronously dispatched step; on the CPU that array can share the
    numpy buffer, so the step may read the advanced positions and its
    tokens change from run to run. The test hands the reference a copy at
    each call (its code is not edited) and so holds the port to the
    reference's intended result."""
    import types
    shim = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    shim.asarray = lambda x, *a, **k: jnp.asarray(
        np.array(x) if isinstance(x, np.ndarray) else x, *a, **k)
    monkeypatch.setattr(j_pipe, "jnp", shim)
    jcfg, cfg, jp = models
    tok = get_tokenizer()
    prob_rng = random.Random(1)
    prompts = [tok.encode(make_prompt(gen_problem(prob_rng)), add_bos=True)
               for _ in range(3)]
    want = j_pipe.generate_batch(
        jp, jcfg, prompts, 24, jax.random.PRNGKey(0),
        sp=JSamplingParams(temperature=0.0, top_k=0, top_p=1.0))
    got = t_pipe.generate_batch(
        _bridge(jp), cfg, prompts, 24, None,
        sp=SamplingParams(temperature=0.0, top_k=0, top_p=1.0))
    assert got == want


def _rendered_traces(mod, n, seed):
    """SampledTrace records of ``mod`` from rendered gold and corrupted
    traces (they carry step boundaries whatever the model)."""
    tok = get_tokenizer()
    rng = random.Random(seed)
    out = []
    for i in range(n):
        p = gen_problem(rng)
        ids, ok = j_data.render_example(p, 1.0 if i % 2 else 0.0, rng)
        plen = len(tok.encode(make_prompt(p), add_bos=True))
        out.append(mod.SampledTrace(problem=p, token_ids=ids,
                                    prompt_len=plen,
                                    text=tok.decode(ids[plen:]),
                                    answer=None, correct=ok))
    return out


def test_collect_boundary_hiddens_matches_jax(models):
    jcfg, cfg, jp = models
    jh, jy, jt = j_pipe.collect_boundary_hiddens(
        jp, jcfg, _rendered_traces(j_pipe, 6, 3), batch=4)
    th, ty, tt = t_pipe.collect_boundary_hiddens(
        _bridge(jp), cfg, _rendered_traces(t_pipe, 6, 3), batch=4)
    assert len(jh) > 0 and th.shape == jh.shape and th.dtype == np.float32
    np.testing.assert_allclose(th, jh, **HIDDEN_TOL)
    assert np.array_equal(ty, jy) and np.array_equal(tt, jt)
    balanced = t_pipe.balance_traces(_rendered_traces(t_pipe, 6, 3), 2,
                                     seed=1)
    want = j_pipe.balance_traces(_rendered_traces(j_pipe, 6, 3), 2, seed=1)
    assert [t.token_ids for t in balanced] == [t.token_ids for t in want]


def test_scorer_dataset_matches_jax(models):
    jcfg, cfg, jp = models
    jh, jy, jt = j_data.scorer_dataset(
        jp, jcfg, lambda p, t: jm.forward_full(p, jcfg, t)["hidden"],
        num_traces=6, seed=2, batch=4)
    th, ty, tt = t_data.scorer_dataset(
        _bridge(jp), cfg, lambda p, t: tm.forward_full(p, cfg, t)["hidden"],
        num_traces=6, seed=2, batch=4)
    np.testing.assert_allclose(th, jh, **HIDDEN_TOL)
    assert np.array_equal(ty, jy) and np.array_equal(tt, jt)


def test_build_step_scorer_and_train_lm_on_cpu(models):
    """The pipeline end to end in the port at a tiny size: a few LM steps
    from a seeded init, then sampling, labelling and scorer training
    (the rendered-trace fallback when the sampled traces give one class);
    the entry points refuse a missing card unless told the CPU."""
    _, cfg, _ = models
    params, hist = t_trainer.train_lm(
        cfg, t_trainer.TrainConfig(steps=3, seq_len=32, batch_size=2,
                                   log_every=1), verbose=False, device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    scorer, info = t_pipe.build_step_scorer(params, cfg, n_problems=2,
                                            n_samples=2, per_class=4,
                                            scfg=t_scorer.ScorerTrainConfig(
                                                max_epochs=2))
    assert scorer["w1"].shape == (cfg.d_model, t_scorer.SCORER_HIDDEN)
    assert info["num_steps"] >= 8 and 0.0 < info["pos_rate"] < 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_trainer.train_lm(cfg, t_trainer.TrainConfig(steps=1))
