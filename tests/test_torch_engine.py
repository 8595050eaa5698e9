"""Greedy ``Engine.serve_batch`` of the port against the JAX engine, on the
same (bridged) weights and scorer, for every method: identical tokens,
statuses and prune decisions, step scores and confidences within 1e-4,
scores in the same order.

The parity runs use f32 params and f32 pools, where the two frameworks
differ only in summation order (~1e-6), so greedy decisions cannot split
on a rounding difference; tests/test_torch_engine_paths.py adds a bf16
run. The port runs on the CPU both dense (``use_kernel=False``) and
through its kernel wrappers (``use_kernel=True``, whose CPU path is the
plain version, as interpret mode is for the JAX package). The JAX engine
runs dense: its kernel-path multi-request scenario fails on this tree.
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
from repro.core.pruning import make_policy as j_make_policy  # noqa: E402
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.data.arithmetic import make_prompt  # noqa: E402
from repro.data.tokenizer import get_tokenizer  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro.serving.evaluate import make_problems  # noqa: E402
from repro.serving.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.pruning import make_policy as t_make_policy  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

TOL = 1e-4  # step scores and confidences, f32

POLICY_KW = {
    "cot": {}, "sc": {}, "step": {},
    "deepconf": {"warmup": 2, "keep_pct": 0.5, "min_tokens": 8},
    "slimsc": {"threshold": 0.5, "check_every": 16},
}


@pytest.fixture(scope="module")
def setup():
    return make_setup("f32")


def make_setup(dt):
    jcfg = j_serving_config()
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    if dt == "f32":
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    tok = get_tokenizer()
    prompts = [tok.encode(make_prompt(p), add_bos=True)
               for p in make_problems(3, seed=11)]
    return {"jcfg": jcfg, "cfg": serving_config(), "jp": jp, "js": js,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "ts": scorer_from_numpy(jax.device_get(js), device="cpu"),
            "prompts": prompts, "kv_dtype": dt}


def engine_kw(s, max_new=40, **kw):
    base = dict(max_batch=8, num_blocks=16, capacity=128,
                max_new_tokens=max_new, use_kernel=False, faults=None,
                kv_dtype=s["kv_dtype"], prefix_cache=True)
    base.update(kw)
    return base


def _greedy(mod, max_new):
    return mod(temperature=0.0, top_k=0, top_p=1.0, max_new_tokens=max_new)


def serve_jax(s, method, prompts, n, waves=None, **kw):
    ecfg = je.EngineConfig(sampling=_greedy(JSamplingParams,
                                            kw.get("max_new_tokens", 40)),
                           **kw)
    policy = j_make_policy(method, **POLICY_KW[method])
    eng = je.Engine(s["jp"], s["jcfg"], ecfg, policy,
                    scorer_params=s["js"] if policy.uses_scorer else None)
    return _serve(eng, je.Request, j_make_policy, method, prompts, n, waves)


def serve_torch(s, method, prompts, n, waves=None, **kw):
    ecfg = te.EngineConfig(sampling=_greedy(SamplingParams,
                                            kw.get("max_new_tokens", 40)),
                           **kw)
    policy = t_make_policy(method, **POLICY_KW[method])
    eng = te.Engine(s["tp"], s["cfg"], ecfg, policy,
                    scorer_params=s["ts"] if policy.uses_scorer else None,
                    device="cpu")
    return _serve(eng, te.Request, t_make_policy, method, prompts, n, waves)


def _serve(eng, request_cls, make_policy, method, prompts, n, waves):
    """Serve ``prompts`` (request i gets prompt i) in ``waves`` of request
    indices on one engine (one wave of all requests by default)."""
    waves = waves or [list(range(len(prompts)))]
    results = []
    for wave in waves:
        reqs = [request_cls(request_id=i, prompt_tokens=list(prompts[i]),
                            n_traces=n,
                            policy=make_policy(method, **POLICY_KW[method]))
                for i in wave]
        results += eng.serve_batch(reqs)
    assert eng.pool_drained()
    return eng, results


def assert_same_results(jres, tres, tol=TOL):
    assert len(jres) == len(tres)
    for jr, tr in zip(jres, tres):
        assert tr.request_id == jr.request_id
        assert tr.status == jr.status
        assert tr.answer == jr.answer
        assert (tr.num_pruned, tr.num_preemptions, tr.total_tokens) == \
            (jr.num_pruned, jr.num_preemptions, jr.total_tokens)
        assert tr.metrics.cached_tokens == jr.metrics.cached_tokens
        for jt, tt in zip(jr.traces, tr.traces):
            assert tt.status.value == jt.status.value, (jr.request_id,
                                                        jt.trace_id)
            assert tt.output_tokens == jt.output_tokens
            assert tt.prefill_count == jt.prefill_count
            np.testing.assert_allclose(tt.step_scores, jt.step_scores,
                                       rtol=0, atol=tol)
            np.testing.assert_allclose(tt.token_confidences,
                                       jt.token_confidences, rtol=0,
                                       atol=tol)
        assert_same_order([t.score for t in jr.traces],
                          [t.score for t in tr.traces], tol)


def assert_same_order(a, b, tol):
    """Every pair of traces the JAX scores rank apart by more than ``tol``
    the port ranks the same way (closer pairs are ties)."""
    for i in range(len(a)):
        for j in range(len(a)):
            if a[i] - a[j] > tol:
                assert b[i] > b[j], (i, j, a, b)


@pytest.mark.parametrize("method", ["cot", "sc", "step", "deepconf",
                                    "slimsc"])
def test_methods_match_jax(setup, method):
    n = 1 if method == "cot" else 4
    kw = engine_kw(setup)
    _, jres = serve_jax(setup, method, setup["prompts"][:2], n, **kw)
    for use_kernel in (False, True):
        eng, tres = serve_torch(setup, method, setup["prompts"][:2], n,
                                **dict(kw, use_kernel=use_kernel))
        assert eng.use_kernel == use_kernel
        assert eng.fused_scorer == (use_kernel and method == "step")
        assert_same_results(jres, tres)
    # the scenario exercises each method's own decision: the pool is tight
    # enough for STEP to prune and SC to preempt, and the signal-triggered
    # policies terminate traces
    if method in ("step", "deepconf", "slimsc"):
        assert sum(r.num_pruned for r in jres) > 0
    if method == "sc":
        assert sum(r.num_preemptions for r in jres) > 0
