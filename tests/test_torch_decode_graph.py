"""The decode horizon's graph runner (``serving/cuda_graph.py``) on the
CPU, where it stages inputs and outputs as on the card but calls the
horizon itself: an engine that decodes through it gives exactly the
tokens, statuses, scores and prune decisions of an engine that calls the
horizon directly (``_eager_decode``), across the scheduler's paths that
refresh its inputs between ticks. Stale-buffer faults live in that
staging, which is why it runs here too.

The engines run the port's own seeded params at the smoke configs, f32,
on the kernel path (the wrappers' plain versions here). The card holds
the captured graphs to the eager horizon in tests/test_torch_cuda.py.
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.core.scorer import init_scorer  # noqa: E402
from repro_torch.data.tokenizer import get_tokenizer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.cuda_graph import DecodeGraph  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

GREEDY = SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                        max_new_tokens=40)
SAMPLED = SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                         max_new_tokens=40)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen3-4b-thinking", "mamba2-2.7b"):
        cfg = serving_config(arch)
        g = torch.Generator().manual_seed(0)
        out[arch] = (cfg, _f32(init_params(cfg, g)),
                     init_scorer(g, cfg.d_model))
    return out


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _prompts():
    """Three short prompts and one of 37 tokens (more than two blocks, so
    a second request for it finds them parked in the prefix cache)."""
    tok = get_tokenizer()
    texts = ["3+5-2=", "12-4+7=1", "9+9=", "6-1+2-3=" * 4 + "1+1="]
    return [tok.encode(t, add_bos=True) for t in texts]


# case -> (arch, EngineConfig overrides, waves of (prompt, traces,
#          arrival, sampling))
CASES = {
    # two serve_batch calls on one engine: the pool is zeroed in place
    "two_serves": ("qwen3-4b-thinking", dict(prefix_cache=False),
                   [[(0, 8, 0.0, None)], [(1, 8, 0.0, None)]]),
    # a horizon-4 run that drops to horizon 1 under a short free list
    "horizon_fallback": ("qwen3-4b-thinking", dict(num_blocks=12),
                         [[(0, 4, 0.0, None), (1, 4, 0.0, None),
                           (2, 4, 0.0, None)]]),
    # prefix-cache hits: the second wave forks the first's parked blocks
    "prefix_hits": ("qwen3-4b-thinking",
                    dict(num_blocks=40, prefill_chunk_size=4),
                    [[(3, 3, 0.0, None)], [(3, 3, 0.0, None)]]),
    # lanes admitted and released between ticks: more traces than slots,
    # requests arriving while others decode
    "admit_release": ("qwen3-4b-thinking", dict(max_new_tokens=24),
                      [[(0, 4, 0.0, None), (1, 4, 0.0, None),
                        (2, 3, 0.002, None), (3, 3, 0.004, None)]]),
    # the lane-wise sampler on mixed per-request params, sampled
    "lanewise": ("qwen3-4b-thinking", dict(),
                 [[(0, 4, 0.0, SAMPLED), (1, 4, 0.0, GREEDY)]]),
    "mamba2_two_serves": ("mamba2-2.7b", dict(),
                          [[(0, 4, 0.0, None)], [(1, 8, 0.0, None)]]),
    "mamba2_sampled": ("mamba2-2.7b", dict(sampling=SAMPLED),
                       [[(0, 8, 0.0, None)]]),
}


def _serve(models, case, eager):
    arch, over, waves = CASES[case]
    cfg, params, scorer = models[arch]
    kw = dict(max_batch=8, num_blocks=16, capacity=128, max_new_tokens=40,
              sampling=GREEDY, use_kernel=True, decode_horizon=4,
              faults=None, kv_dtype="f32")
    kw.update(over)
    eng = te.Engine(params, cfg, te.EngineConfig(**kw), make_policy("step"),
                    scorer_params=scorer, device="cpu", _eager_decode=eager)
    prompts = _prompts()
    results, pools = [], []
    for w, wave in enumerate(waves):
        reqs = [te.Request(request_id=10 * w + i,
                           prompt_tokens=list(prompts[p]), n_traces=n,
                           policy=make_policy("step"), arrival_time=t,
                           sampling=sp)
                for i, (p, n, t, sp) in enumerate(wave)]
        results += eng.serve_batch(reqs)
        pools.append({k: v.data_ptr() for k, v in eng._pool.items()})
        assert eng.pool_drained()
    return eng, results, pools


@pytest.mark.parametrize("case", list(CASES))
def test_runner_matches_direct_call(models, case):
    direct, want, _ = _serve(models, case, eager=True)
    eng, got, pools = _serve(models, case, eager=False)
    assert all(isinstance(f, DecodeGraph) for f in eng._decode_fns.values())
    assert not any(isinstance(f, DecodeGraph)
                   for f in direct._decode_fns.values())
    assert set(eng._decode_fns) == set(direct._decode_fns)
    assert all(p == pools[0] for p in pools)   # one pool for life
    assert eng.horizon_fallbacks == direct.horizon_fallbacks
    for r, w in zip(got, want):
        assert (r.status, r.num_pruned, r.num_preemptions, r.total_tokens,
                r.metrics.cached_tokens) == \
            (w.status, w.num_pruned, w.num_preemptions, w.total_tokens,
             w.metrics.cached_tokens)
        for t, u in zip(r.traces, w.traces):
            assert t.status == u.status
            assert t.output_tokens == u.output_tokens
            assert t.token_confidences == u.token_confidences
            assert t.step_scores == u.step_scores
    if case == "horizon_fallback":
        assert set(eng._decode_fns) == {(4, False), (1, False)}
        assert eng.horizon_fallbacks > 0
    if case == "prefix_hits":
        assert got[1].metrics.cached_tokens > 0
    if case == "lanewise":
        assert set(eng._decode_fns) == {(4, True)}
    if case in ("two_serves", "admit_release", "mamba2_two_serves"):
        assert sum(r.num_pruned for r in got) > 0


def _echo(params, cache, tokens, positions, limits, block_tables, rng,
          scorer_params, *samp):
    """A stand-in horizon: every output derives from the inputs."""
    cache["state"] += 1
    return (tokens[:, None] + 1, positions[:, None].float(),
            limits[:, None].float(), (limits > 0)[:, None],
            block_tables[:, :1] > 0, tokens + 1, positions + limits,
            cache, rng)


def test_runner_stages_inputs_and_outputs():
    """The outputs are the same tensors every call, overwritten; the
    inputs are copied in, so the caller's tensors (its own last outputs
    among them) may change afterwards; the cache is updated in place."""
    run = DecodeGraph(_echo, torch.device("cpu"))
    params, cache = {}, {"state": torch.zeros(2)}
    toks = torch.tensor([1, 2], dtype=torch.int32)
    pos = torch.tensor([5, 6], dtype=torch.int32)
    lim = torch.tensor([4, 0], dtype=torch.int32)
    bt = torch.tensor([[3, 4], [0, 0]], dtype=torch.int32)
    first = run(params, cache, toks, pos, lim, bt, None, None)
    assert first[7] is cache and cache["state"].tolist() == [1.0, 1.0]
    toks.fill_(9)   # a later change to the caller's tensor is not seen
    assert first[5].tolist() == [2, 3]
    second = run(params, cache, first[5], first[6], lim, bt, None, None)
    assert all(a is b for a, b in zip(first[:7], second[:7]))
    assert second[5].tolist() == [3, 4] and second[6].tolist() == [13, 6]


def test_runner_refuses_other_pool_tensors():
    run = DecodeGraph(_echo, torch.device("cpu"))
    params, cache = {}, {"state": torch.zeros(2)}
    args = (torch.zeros(2, dtype=torch.int32),) * 3 + (
        torch.zeros(2, 1, dtype=torch.int32), None, None)
    run(params, cache, *args)
    with pytest.raises(RuntimeError, match="captured over"):
        run(params, {"state": torch.zeros(2)}, *args)
    with pytest.raises(RuntimeError, match="captured over"):
        run({}, cache, *args)


def test_engine_pool_is_reset_in_place(models):
    """A CPU or CUDA engine keeps one pool: each serve without the prefix
    cache gets the same tensors back, zeroed (unit scales for an int8
    pool), as the JAX engine's fresh pool would be."""
    cfg, params, scorer = models["qwen3-4b-thinking"]
    ecfg = te.EngineConfig(max_batch=4, num_blocks=8, capacity=64,
                           sampling=GREEDY, faults=None, kv_dtype="int8",
                           prefix_cache=False)
    eng = te.Engine(params, cfg, ecfg, make_policy("step"), device="cpu")
    first = eng._take_kv_cache()
    for t in first.values():
        t.fill_(3)
    second = eng._take_kv_cache()
    assert second is first
    assert not second["k_pool"].any() and not second["v_pool"].any()
    assert bool((second["k_scale"] == 1).all())
    assert bool((second["v_scale"] == 1).all())
    ops.reset_launch_counts()
    assert ops.launch_counts()["decode_graph_captures"] == 0
