"""The port's copies of the host modules (tokenizer, problems, traces,
votes, pruning policies, allocator, prefix cache, fault plans) give the
JAX package's results on the same inputs."""
import random

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the JAX package's modules import it)
import numpy as np  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.core import pruning as j_pruning  # noqa: E402
from repro.core import segmentation as j_seg  # noqa: E402
from repro.core import trace as j_trace  # noqa: E402
from repro.core import voting as j_voting  # noqa: E402
from repro.data import arithmetic as j_arith  # noqa: E402
from repro.data import tokenizer as j_tok  # noqa: E402
from repro.models import kv_quant as j_kvq  # noqa: E402
from repro.serving import evaluate as j_eval  # noqa: E402
from repro.serving import faults as j_faults  # noqa: E402
from repro.serving import kv_manager as j_kv  # noqa: E402
from repro.serving import prefix_cache as j_pc  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core import segmentation as t_seg  # noqa: E402
from repro_torch.core import trace as t_trace  # noqa: E402
from repro_torch.core import voting as t_voting  # noqa: E402
from repro_torch.data import arithmetic as t_arith  # noqa: E402
from repro_torch.data import tokenizer as t_tok  # noqa: E402
from repro_torch.models import kv_quant as t_kvq  # noqa: E402
from repro_torch.serving import evaluate as t_eval  # noqa: E402
from repro_torch.serving import faults as t_faults  # noqa: E402
from repro_torch.serving import kv_manager as t_kv  # noqa: E402
from repro_torch.serving import prefix_cache as t_pc  # noqa: E402


def _texts(n=40, seed=3):
    rng = random.Random(seed)
    probs = [j_arith.gen_problem(rng) for _ in range(n)]
    out = []
    for i, p in enumerate(probs):
        text, _ = j_arith.render_trace(p, corrupt_from=(i % 3) or None,
                                       rng=random.Random(i))
        out.append(j_arith.make_prompt(p) + text)
    return out


# ---------------------------------------------------------------------------
# tokenizer, problems, configs
# ---------------------------------------------------------------------------

def test_tokenizer_encode_decode_match():
    jt, tt = j_tok.get_tokenizer(), t_tok.get_tokenizer()
    assert jt.vocab == tt.vocab
    for text in _texts() + ["<think>1+2=3\n\n</think>boxed{3}", "", "x?"]:
        for bos, eos in ((False, False), (True, True)):
            ids = jt.encode(text, add_bos=bos, add_eos=eos)
            assert tt.encode(text, add_bos=bos, add_eos=eos) == ids
            assert tt.decode(ids) == jt.decode(ids)
    # ids past the 25-token vocab (a full-vocab model's samples) are skipped
    assert tt.decode([11, 151935, 12, 30]) == jt.decode([11, 151935, 12, 30])


def test_problems_and_answers_match():
    jp = j_eval.make_problems(30, seed=7)
    tp = t_eval.make_problems(30, seed=7)
    assert [(p.operands, p.ops) for p in jp] == [(p.operands, p.ops)
                                                 for p in tp]
    for p in tp:
        assert t_arith.make_prompt(p) == j_arith.make_prompt(p)
    for text in _texts():
        assert t_arith.extract_answer(text) == j_arith.extract_answer(text)
    assert t_eval.poisson_arrivals(6, 2.5, seed=1) == \
        j_eval.poisson_arrivals(6, 2.5, seed=1)


def test_serving_config_matches():
    jc, tc = j_registry.serving_config(), t_registry.serving_config()
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "qk_norm", "rope_theta",
                  "tie_embeddings", "kv_block_size", "norm_eps"):
        assert getattr(tc, field) == getattr(jc, field), field
    full_j = j_registry.get_config("qwen3-4b-thinking")
    full_t = t_registry.get_config("qwen3-4b-thinking")
    assert full_t.__dict__ == full_j.__dict__
    with pytest.raises(KeyError, match="ROADMAP"):
        t_registry.get_config("mixtral-8x7b")


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8", "fp8"])
def test_pool_block_bytes_match(kv_dtype):
    for jc, tc in ((j_registry.serving_config(),
                    t_registry.serving_config()),
                   (j_registry.get_config("qwen3-4b-thinking"),
                    t_registry.get_config("qwen3-4b-thinking"))):
        assert t_kvq.pool_block_bytes(tc, kv_dtype) == \
            j_kvq.pool_block_bytes(jc, kv_dtype)


def test_quantized_pool_not_ported():
    """The quantized pools are ported for the dense GQA stack; like the
    JAX package, the port refuses them where chunked prefill (the dense
    paged-attention family) is not supported."""
    cfg = t_registry.serving_config()
    for kv_dtype in ("int8", "fp8"):
        assert t_kvq.resolve_kv_dtype(kv_dtype, cfg, True) == kv_dtype
        with pytest.raises(NotImplementedError, match="dense GQA"):
            t_kvq.resolve_kv_dtype(kv_dtype, cfg, False)


# ---------------------------------------------------------------------------
# segmentation, votes, policies
# ---------------------------------------------------------------------------

def test_segmentation_matches():
    tok = j_tok.get_tokenizer()
    jd = j_seg.StepBoundaryDetector([tok.step_id], tok.think_close_id)
    td = t_seg.StepBoundaryDetector([tok.step_id], tok.think_close_id)
    for text in _texts():
        ids = tok.encode(text)
        assert td.boundaries(ids) == jd.boundaries(ids)
        assert t_seg.split_steps(text) == j_seg.split_steps(text)
        assert t_seg.extract_think(text) == j_seg.extract_think(text)


def test_votes_match():
    rng = np.random.RandomState(0)
    for _ in range(50):
        n = rng.randint(1, 9)
        answers = [None if rng.rand() < 0.2 else str(rng.randint(0, 4))
                   for _ in range(n)]
        weights = list(rng.rand(n))
        assert t_voting.majority_vote(answers) == \
            j_voting.majority_vote(answers)
        assert t_voting.weighted_vote(answers, weights) == \
            j_voting.weighted_vote(answers, weights)


def _traces(mod, seed):
    rng = np.random.RandomState(seed)
    tok = j_tok.get_tokenizer()
    out = []
    for i in range(6):
        t = mod.Trace(trace_id=i, request_id=0, prompt_tokens=[1, 11])
        toks = list(rng.randint(3, 25, size=rng.randint(20, 90)))
        t.extend_output(toks, list(rng.rand(len(toks))))
        t.add_step_scores(list(rng.rand(rng.randint(0, 4))))
        if i % 2:
            boxed = tok.encode(f"boxed{{{i % 3}}}")
            t.extend_output(boxed, [0.5] * len(boxed))
        out.append(t)
    return out


@pytest.mark.parametrize("method,kw", [
    ("step", {}), ("step", {"proactive_free_blocks": 4}), ("sc", {}),
    ("deepconf", {"warmup": 2, "keep_pct": 0.5, "min_tokens": 8}),
    ("slimsc", {"threshold": 0.05, "check_every": 8})])
def test_policy_decisions_match(method, kw):
    for seed in range(4):
        jtr, ttr = _traces(j_trace, seed), _traces(t_trace, seed)
        jp = j_pruning.make_policy(method, **kw)
        tp = t_pruning.make_policy(method, **kw)
        if method == "deepconf":
            jp.record_warmup(jtr[:2])
            tp.record_warmup(ttr[:2])
            assert tp.threshold == jp.threshold
        pressure = dict(free_blocks=1, total_blocks=20, cached_blocks=0,
                        waiting_traces=3, queued_requests=1)
        jp.observe_pressure(j_pruning.AdmissionPressure(**pressure))
        tp.observe_pressure(t_pruning.AdmissionPressure(**pressure))
        ids = lambda ts: [t.trace_id for t in ts]  # noqa: E731
        assert ids(tp.traces_to_terminate(ttr)) == \
            ids(jp.traces_to_terminate(jtr))
        jv, tv = jp.on_memory_full(jtr), tp.on_memory_full(ttr)
        assert (tv and tv.trace_id) == (jv and jv.trace_id)
        assert tp.vote(ttr) == jp.vote(jtr)


# ---------------------------------------------------------------------------
# allocator, reservations, prefix cache, fault plans
# ---------------------------------------------------------------------------

def _allocator_script(kv, pc):
    """One fixed sequence of allocator / reservation / prefix-cache
    operations; returns everything observable along the way."""
    mgr = kv.BlockManager(24, 16, bytes_per_block=1024)
    cache = pc.PrefixCache(mgr)
    log = []
    a = mgr.allocate(5)
    b = mgr.fork(a[:3])
    log += [a, b, mgr.free_blocks, mgr.used_blocks, mgr.is_shared(a[0]),
            mgr.ref_count(a[0]), mgr.blocks_for_tokens(33), mgr.used_bytes]
    res = mgr.reserve(4)
    log += [res.take(2), res.num_taken, res.remaining, mgr.free_blocks]
    log += [res.commit(), mgr.open_reservations]
    res2 = mgr.reserve(3)
    log += [res2.take(1)]
    res2.abort()
    log += [mgr.free_blocks, mgr.open_reservations]
    prompt = list(range(3, 3 + 40))
    # insert moves the holder's references of a[:2] into the cache
    log += [cache.insert(prompt, a[:2]), cache.cached_blocks]
    mgr.free(a[2:])
    log += [cache.match(prompt), cache.match(prompt[:20]),
            cache.match([9] * 40), cache.evictable_blocks]
    log += [cache.evict(1), cache.cached_blocks, mgr.free_blocks]
    log += [mgr.allocate(40), cache.clear(), mgr.free_blocks]
    mgr.free(b)
    mgr.check_invariants()
    cache.check_integrity()
    log += [mgr.free_blocks, list(cache.blocks()),
            (cache.stats.hits, cache.stats.misses)]
    return log


def test_allocator_and_prefix_cache_sequences_match():
    assert _allocator_script(t_kv, t_pc) == _allocator_script(j_kv, j_pc)


@pytest.mark.parametrize("spec", ["step@3", "step@3x5,alloc@4x2",
                                  "nan@6:req=1", "nan@2:slot=3,step@0x2",
                                  "alloc@1x3, nan@5"])
def test_fault_plan_parse_matches(spec):
    jp = j_faults.FaultPlan.parse(spec, seed=4)
    tp = t_faults.FaultPlan.parse(spec, seed=4)
    assert repr(tp) == repr(jp)
    lanes = [(s, s % 2) for s in range(6)]
    for tick in range(10):
        assert tp.alloc_blocked(tick) == jp.alloc_blocked(tick)
        assert tp.nan_victims(tick, lanes) == jp.nan_victims(tick, lanes)
        raised = []
        for plan, exc in ((jp, j_faults.DeviceStepFault),
                          (tp, t_faults.DeviceStepFault)):
            try:
                plan.maybe_step_fault(tick)
                raised.append(False)
            except exc:
                raised.append(True)
        assert raised[0] == raised[1]


@pytest.mark.parametrize("bad", ["", "boom@1", "step", "step@x", "nan@1:q=2"])
def test_fault_plan_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        j_faults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        t_faults.FaultPlan.parse(bad)
