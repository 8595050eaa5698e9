"""End-to-end evaluation harness: run problems through the engine under a
method (cot / sc / slimsc / deepconf / step) and report the paper's three
metrics — accuracy, avg output tokens, latency — plus the Table 3 phase
breakdown (wait / decode / prefill) and, for the continuous-batching
path, the online-serving summary (TTFT / TPOT / e2e percentiles).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import make_policy
from repro_torch.data.arithmetic import Problem, gen_problem, make_prompt
from repro_torch.data.tokenizer import get_tokenizer
from repro_torch.serving.engine import Engine, EngineConfig, Request, RequestResult
from repro_torch.serving.metrics import summarize


@dataclasses.dataclass
class EvalResult:
    method: str
    n_traces: int
    accuracy: float
    avg_tokens: float
    avg_latency_s: float
    total_wait_s: float
    total_decode_s: float
    total_prefill_s: float
    num_pruned: int
    num_preemptions: int
    per_problem: List[dict]
    # online-serving summary (metrics.summarize) — batched path only
    serving: Optional[dict] = None


def make_problems(n: int, seed: int = 1234,
                  n_steps=(3, 6)) -> List[Problem]:
    rng = random.Random(seed)
    return [gen_problem(rng, n_steps) for _ in range(n)]


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0) -> List[float]:
    """Arrival offsets (seconds) for a Poisson process of ``rate_per_s``.

    The benchmark's open-loop load model: exponential inter-arrival
    gaps, cumulative. rate <= 0 degenerates to everything at t=0 (the
    offline batch)."""
    if rate_per_s <= 0:
        return [0.0] * n
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return list(np.cumsum(gaps))


def _aggregate(method: str, n_traces: int, problems: List[Problem],
               results: Sequence[RequestResult], verbose: bool = False,
               with_serving: bool = False) -> EvalResult:
    """Fold per-request RequestResults into the paper's three metrics."""
    records = []
    totals = dict(wait=0.0, decode=0.0, prefill=0.0, pruned=0, preempt=0)
    correct = 0
    for p, res in zip(problems, results):
        ok = res.answer is not None and int(res.answer) == p.answer
        correct += ok
        totals["wait"] += res.wait_s
        totals["decode"] += res.decode_s
        totals["prefill"] += res.prefill_s
        totals["pruned"] += res.num_pruned
        totals["preempt"] += res.num_preemptions
        rec = {
            "qid": res.request_id, "answer": res.answer, "gold": p.answer,
            "correct": bool(ok), "tokens": res.total_tokens,
            "latency_s": res.latency_s, "wait_s": res.wait_s,
            "decode_s": res.decode_s, "prefill_s": res.prefill_s,
            "pruned": res.num_pruned, "preemptions": res.num_preemptions,
        }
        if res.metrics is not None:
            rec["ttft_s"] = res.metrics.ttft_s
            rec["tpot_s"] = res.metrics.tpot_s
            rec["e2e_s"] = res.metrics.e2e_s
        records.append(rec)
        if verbose:
            print(f"  [{method}] q{res.request_id}: ans={res.answer} "
                  f"gold={p.answer} ok={ok} tok={res.total_tokens} "
                  f"lat={res.latency_s:.2f}s wait={res.wait_s:.2f}s")
    n = max(len(problems), 1)
    serving = None
    if with_serving:
        ms = [res.metrics for res in results if res.metrics is not None]
        serving = summarize(ms) if ms else None
    return EvalResult(
        method=method, n_traces=n_traces,
        accuracy=correct / n,
        avg_tokens=float(np.mean([r["tokens"] for r in records])),
        avg_latency_s=float(np.mean([r["latency_s"] for r in records])),
        total_wait_s=totals["wait"], total_decode_s=totals["decode"],
        total_prefill_s=totals["prefill"],
        num_pruned=totals["pruned"], num_preemptions=totals["preempt"],
        per_problem=records, serving=serving)


def evaluate_method(method: str, params: dict, cfg: ModelConfig,
                    problems: List[Problem], n_traces: int,
                    ecfg: Optional[EngineConfig] = None,
                    scorer_params: Optional[dict] = None,
                    policy_kwargs: Optional[dict] = None,
                    mesh=None,
                    verbose: bool = False,
                    device=None) -> EvalResult:
    """One engine + one request at a time — the paper's serial setting.

    ``ecfg=None`` builds the engine config from the ``REPRO_*``
    environment (``EngineConfig.from_env()``). ``device`` is the
    engines' device: CUDA unless the caller names another."""
    tok = get_tokenizer()
    if ecfg is None:
        ecfg = EngineConfig.from_env()
    policy_kwargs = dict(policy_kwargs or {})
    if method == "cot":
        n_traces = 1
    results = []
    for qid, p in enumerate(problems):
        policy = make_policy(method, **policy_kwargs)
        engine = Engine(params, cfg, ecfg, policy,
                        scorer_params=scorer_params
                        if policy.uses_scorer else None,
                        mesh=mesh, device=device)
        prompt = tok.encode(make_prompt(p), add_bos=True)
        results.append(engine.serve(prompt, n_traces, request_id=qid))
    return _aggregate(method, n_traces, problems, results, verbose=verbose)


def evaluate_method_batched(method: str, params: dict, cfg: ModelConfig,
                            problems: List[Problem], n_traces: int,
                            ecfg: Optional[EngineConfig] = None,
                            scorer_params: Optional[dict] = None,
                            policy_kwargs: Optional[dict] = None,
                            arrival_times: Optional[Sequence[float]] = None,
                            on_result: Optional[
                                Callable[[RequestResult], None]] = None,
                            mesh=None,
                            scheduler=None,
                            request_overrides: Optional[
                                Sequence[dict]] = None,
                            verbose: bool = False,
                            device=None) -> EvalResult:
    """All problems submitted to ONE engine as a request queue: traces of
    different requests co-exist in the decode batch and contend for the
    shared block pool (the multi-request serving scenario). Each request
    gets a fresh policy instance so stateful policies (DeepConf warmup
    threshold, Slim-SC cursors) don't leak across concurrent requests.

    ``arrival_times`` (seconds, per problem) turns the batch into an
    online arrival trace (continuous batching); ``on_result`` streams
    each request's ``RequestResult`` the moment it completes.

    ``ecfg=None`` builds the engine config from the ``REPRO_*``
    environment (``EngineConfig.from_env()``). ``scheduler`` selects the
    engine's scheduling policy (e.g. ``serving.TenantScheduler`` for
    weighted fair multi-tenant budgets); ``request_overrides`` supplies
    per-request ``Request`` kwargs — ``tenant``/``priority``/``slo`` and
    the per-request ``sampling``/``max_new_tokens`` overrides.
    ``device`` is the engine's device: CUDA unless the caller names
    another.
    """
    tok = get_tokenizer()
    if ecfg is None:
        ecfg = EngineConfig.from_env()
    policy_kwargs = dict(policy_kwargs or {})
    if method == "cot":
        n_traces = 1
    if arrival_times is None:
        arrival_times = [0.0] * len(problems)
    assert len(arrival_times) == len(problems)
    if request_overrides is None:
        request_overrides = [{}] * len(problems)
    assert len(request_overrides) == len(problems)
    requests = [
        Request(request_id=qid,
                prompt_tokens=tok.encode(make_prompt(p), add_bos=True),
                n_traces=n_traces,
                policy=make_policy(method, **policy_kwargs),
                arrival_time=float(at),
                **extra)
        for qid, (p, at, extra) in enumerate(
            zip(problems, arrival_times, request_overrides))
    ]
    default_policy = make_policy(method, **policy_kwargs)
    engine = Engine(params, cfg, ecfg, default_policy,
                    scorer_params=scorer_params
                    if default_policy.uses_scorer else None,
                    mesh=mesh, scheduler=scheduler, device=device)
    results = engine.serve_batch(requests, on_complete=on_result)
    return _aggregate(method, n_traces, problems, results, verbose=verbose,
                      with_serving=True)
