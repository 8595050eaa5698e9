"""The port's engine on its other paths: the decode horizon with the
prefix cache on and off, chunked prefill with a prefix-cache hit, bf16
weights (each against the JAX engine, greedy), the paper's claims under
memory pressure pinned in the port itself, and the entry points' device
rules.

The tight pool of tests/test_engine.py (``num_blocks=12, max_new=100``)
is not a parity oracle: those JAX tests fail on this tree. The port pins
the claims there directly: STEP prunes the lowest-scored trace and no
trace waits, while SC preempts and traces wait.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro_torch.core.pruning import StepPolicy, make_policy  # noqa: E402
from repro_torch.core.trace import TraceStatus  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving import evaluate as tev  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from test_torch_engine import (assert_same_results, engine_kw,  # noqa: E402
                               make_setup, serve_jax, serve_torch)


@pytest.fixture(scope="module")
def setup():
    return make_setup("f32")


@pytest.mark.parametrize("method,prefix_cache,horizon", [
    ("step", False, 4), ("sc", True, 4), ("step", True, 1)])
def test_horizon_and_cache_match_jax(setup, method, prefix_cache, horizon):
    kw = engine_kw(setup, prefix_cache=prefix_cache, decode_horizon=horizon)
    _, jres = serve_jax(setup, method, setup["prompts"], 3, **kw)
    eng, tres = serve_torch(setup, method, setup["prompts"], 3,
                            **dict(kw, use_kernel=True))
    assert (eng.prefix_cache is not None) == prefix_cache
    assert_same_results(jres, tres)


def test_chunked_prefill_prefix_hit_matches_jax(setup):
    """A 37-token prompt in chunks of 8, served in two waves on one
    engine: the second wave's copy of the prompt forks the first wave's
    parked blocks and chunk-prefills only the suffix."""
    shared = setup["prompts"][0] + setup["prompts"][1][1:] + \
        setup["prompts"][2][1:]
    prompts = [shared, setup["prompts"][1], shared]
    kw = engine_kw(setup, num_blocks=40, prefill_chunk_size=8,
                   decode_horizon=4)
    waves = [[0, 1], [2]]
    _, jres = serve_jax(setup, "step", prompts, 3, waves=waves, **kw)
    eng, tres = serve_torch(setup, "step", prompts, 3, waves=waves,
                            **dict(kw, use_kernel=True))
    assert_same_results(jres, tres)
    assert len(shared) > 16 and tres[2].metrics.cached_tokens > 0
    assert eng.prefix_cache.stats.hits >= 1


def test_bf16_step_matches_jax():
    """bf16 weights and pool: identical greedy tokens, statuses and prune
    decisions; step scores and confidences within 1e-2 (bf16 hidden states
    round to neighbouring values in the two frameworks, see
    test_torch_model)."""
    s = make_setup("bf16")
    kw = engine_kw(s)
    _, jres = serve_jax(s, "step", s["prompts"][:2], 4, **kw)
    _, tres = serve_torch(s, "step", s["prompts"][:2], 4,
                          **dict(kw, use_kernel=True))
    assert_same_results(jres, tres, tol=1e-2)


# ---------------------------------------------------------------------------
# the paper's claims under memory pressure, pinned in the port
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecordingStep(StepPolicy):
    """STEP that records every memory-full decision."""
    decisions: list = dataclasses.field(default_factory=list)

    def on_memory_full(self, running, pressure=None):
        victim = super().on_memory_full(running, pressure)
        self.decisions.append(([t.score for t in running if t.alive],
                               victim))
        return victim


def _tight(setup, method, policy):
    sp = SamplingParams(max_new_tokens=100)   # temperature 0.8: traces differ
    ecfg = te.EngineConfig(max_batch=8, num_blocks=12, capacity=128,
                           max_new_tokens=100, sampling=sp, faults=None,
                           use_kernel=True, prefix_cache=True)
    eng = te.Engine(setup["tp"], setup["cfg"], ecfg, policy,
                    scorer_params=setup["ts"], device="cpu")
    return eng, eng.serve(setup["prompts"][0], 8)


def test_step_under_pressure_prunes_lowest_and_never_waits(setup):
    policy = RecordingStep()
    eng, res = _tight(setup, "step", policy)
    assert res.num_pruned > 0 and policy.decisions
    for scores, victim in policy.decisions:
        assert victim is not None and victim.score == min(scores)
    assert res.wait_s == 0.0 and res.num_preemptions == 0
    assert all(t.status in (TraceStatus.FINISHED, TraceStatus.PRUNED)
               for t in res.traces)
    assert eng.pool_drained()


def test_sc_under_pressure_preempts_and_waits(setup):
    eng, res = _tight(setup, "sc", make_policy("sc"))
    assert res.num_preemptions > 0 and res.wait_s > 0
    assert any(t.prefill_count > 1 for t in res.traces)
    assert all(t.status == TraceStatus.FINISHED for t in res.traces)
    assert eng.pool_drained()


# ---------------------------------------------------------------------------
# entry points: CUDA unless the caller names the CPU
# ---------------------------------------------------------------------------

def test_engine_device_rules(setup, monkeypatch):
    ecfg = te.EngineConfig(faults=None)
    policy = make_policy("sc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.Engine(setup["tp"], setup["cfg"], ecfg, policy, device=device)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        te.Engine(setup["tp"], setup["cfg"], ecfg, policy, mesh=object(),
                  device="cpu")
    # the quantized pools are served on the CPU too; an unknown one raises
    eng = te.Engine(setup["tp"], setup["cfg"],
                    te.EngineConfig(faults=None, kv_dtype="int8"), policy,
                    device="cpu")
    assert eng.kv_block_bytes == te.kv_quant.pool_block_bytes(setup["cfg"],
                                                              "int8")
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        te.Engine(setup["tp"], setup["cfg"],
                  te.EngineConfig(faults=None, kv_dtype="int4"), policy,
                  device="cpu")
    cpu = torch.device("cpu")
    assert te.resolve_use_kernel("auto", cpu) is False
    assert te.resolve_use_kernel(True, cpu) is True
    assert te.resolve_use_kernel("auto", torch.device("cuda")) is True
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.evaluate_method("cot", setup["tp"], setup["cfg"],
                            tev.make_problems(1), 1, ecfg=ecfg)


def test_from_env_reads_the_same_names(monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_HORIZON", "4")
    monkeypatch.setenv("REPRO_NUM_BLOCKS", "33")
    monkeypatch.setenv("REPRO_USE_KERNEL", "auto")
    ecfg = te.EngineConfig.from_env(max_batch=5)
    assert (ecfg.decode_horizon, ecfg.num_blocks, ecfg.max_batch,
            ecfg.use_kernel) == (4, 33, 5, "auto")
    monkeypatch.setenv("REPRO_CAPACITY", "0")
    with pytest.raises(ValueError, match="REPRO_CAPACITY"):
        te.EngineConfig.from_env()


def test_evaluate_entry_points_on_cpu(setup):
    problems = tev.make_problems(2, seed=3)
    ecfg = te.EngineConfig(max_batch=8, num_blocks=24, capacity=64,
                           max_new_tokens=24, faults=None,
                           sampling=SamplingParams(max_new_tokens=24))
    for fn in (tev.evaluate_method, tev.evaluate_method_batched):
        res = fn("step", setup["tp"], setup["cfg"], problems, 4, ecfg=ecfg,
                 scorer_params=setup["ts"], device="cpu")
        assert len(res.per_problem) == 2 and 0.0 <= res.accuracy <= 1.0
        assert np.isfinite(res.avg_tokens) and res.avg_tokens > 0
