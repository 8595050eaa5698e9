"""Per-request serving metrics for the continuous-batching engine.

The paper's Table 3 accounts engine seconds (prefill / decode / wait);
online serving additionally needs the request-facing latencies every
serving system reports:

  * TTFT — time to first token: first generated token of ANY of the
    request's traces, measured from the request's *arrival* (not from
    batch start). Queueing before admission, shared-prompt prefill and
    chunked-prefill interleaving all land in TTFT.
  * TPOT — time per output token after the first: steady-state decode
    pace as the request experienced it, including scheduler stalls,
    preemption-induced recompute and cross-request contention. For a
    request fanning into N traces the denominator is the total new
    tokens across traces minus one (the batch generates N tokens per
    engine step, so TPOT is a *request-level* pace, not a per-trace one).
  * e2e latency — arrival to completion (all traces finished/pruned).

``summarize`` folds a set of ``RequestMetrics`` into the percentile
table the load benchmark writes to ``BENCH_serving.json``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock serving metrics for one request (times in seconds,
    relative to the engine's serve-loop start)."""

    request_id: int
    arrival_s: float                 # when the request entered the queue
    admitted_s: Optional[float]      # first trace admitted to a slot
    first_token_s: Optional[float]   # first generated token (any trace)
    finished_s: Optional[float]      # all traces finished/pruned
    prompt_tokens: int = 0
    output_tokens: int = 0           # total new tokens across traces
    n_traces: int = 0
    num_pruned: int = 0
    num_preemptions: int = 0
    wait_s: float = 0.0              # memory-induced waiting (Table 3)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    cached_tokens: int = 0           # prompt tokens served from the
    #                                  prefix cache (no prefill compute)
    # multi-tenant serving (scheduler.TenantScheduler)
    tenant: str = "default"
    priority: int = 0
    degraded_traces: int = 0         # traces shed by SLO admission
    slo_ttft_s: Optional[float] = None   # the request's SLO targets
    slo_tpot_s: Optional[float] = None   # (None = no objective attached)
    # fault-tolerant serving: how the request ended ("completed" |
    # "cancelled" | "deadline_exceeded" | "failed") and how many of its
    # traces were quarantined/aborted by fault recovery.
    status: str = "completed"
    failed_traces: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        if self.first_token_s is None or self.finished_s is None:
            return None
        n_after_first = max(self.output_tokens - 1, 1)
        return (self.finished_s - self.first_token_s) / n_after_first

    @property
    def e2e_s(self) -> Optional[float]:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s

    @property
    def ttft_attained(self) -> Optional[bool]:
        """Whether the request met its TTFT objective (None = no SLO)."""
        if self.slo_ttft_s is None:
            return None
        return self.ttft_s is not None and self.ttft_s <= self.slo_ttft_s

    @property
    def tpot_attained(self) -> Optional[bool]:
        if self.slo_tpot_s is None:
            return None
        return self.tpot_s is not None and self.tpot_s <= self.slo_tpot_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ttft_s"] = self.ttft_s
        d["tpot_s"] = self.tpot_s
        d["e2e_s"] = self.e2e_s
        return d


def percentiles(xs: Sequence[float],
                ps: Sequence[float] = (50, 90, 99)
                ) -> Dict[str, Optional[float]]:
    """Linear-interpolated percentiles as {"p50": ..., "p90": ...}.

    An empty input yields ``None`` values (JSON ``null``), never NaN:
    NaN survives a round-trip through ``json`` as the non-standard token
    ``NaN`` and — worse — compares unequal to itself, so a regression
    gate diffing two NaN-bearing payloads would silently pass. ``None``
    fails loudly instead."""
    if not xs:
        return {f"p{_fmt(p)}": None for p in ps}
    vals = np.percentile([float(x) for x in xs], list(ps))
    return {f"p{_fmt(p)}": float(v) for p, v in zip(ps, vals)}


def _fmt(p: float) -> str:
    return str(int(p)) if float(p).is_integer() else str(p)


def summarize(metrics: Sequence[RequestMetrics],
              ps: Sequence[float] = (50, 90, 99)) -> dict:
    """Aggregate request metrics into the BENCH_serving.json payload."""
    done = [m for m in metrics if m.finished_s is not None]
    ttfts = [m.ttft_s for m in done if m.ttft_s is not None]
    tpots = [m.tpot_s for m in done if m.tpot_s is not None]
    e2es = [m.e2e_s for m in done]
    span = (max((m.finished_s for m in done), default=0.0)
            - min((m.arrival_s for m in metrics), default=0.0))
    total_tokens = sum(m.output_tokens for m in done)
    total_prompt = sum(m.prompt_tokens for m in metrics)
    total_cached = sum(m.cached_tokens for m in metrics)
    return {
        "num_requests": len(metrics),
        "num_completed": len(done),
        "total_output_tokens": total_tokens,
        "makespan_s": span,
        "throughput_tok_per_s": total_tokens / span if span > 0 else 0.0,
        "throughput_req_per_s": len(done) / span if span > 0 else 0.0,
        "ttft_s": percentiles(ttfts, ps),
        "tpot_s": percentiles(tpots, ps),
        "e2e_s": percentiles(e2es, ps),
        "mean_ttft_s": _mean(ttfts),
        "mean_tpot_s": _mean(tpots),
        "mean_e2e_s": _mean(e2es),
        "total_wait_s": sum(m.wait_s for m in metrics),
        "total_prefill_s": sum(m.prefill_s for m in metrics),
        "total_decode_s": sum(m.decode_s for m in metrics),
        "num_pruned": sum(m.num_pruned for m in metrics),
        "num_preemptions": sum(m.num_preemptions for m in metrics),
        "total_prompt_tokens": total_prompt,
        "total_cached_tokens": total_cached,
        "prefix_hit_rate": (total_cached / total_prompt
                            if total_prompt > 0 else 0.0),
        "requests_with_prefix_hit": sum(
            m.cached_tokens > 0 for m in metrics),
        "degraded_traces": sum(m.degraded_traces for m in metrics),
        "num_cancelled": sum(m.status == "cancelled" for m in metrics),
        "num_deadline_exceeded": sum(
            m.status == "deadline_exceeded" for m in metrics),
        "num_failed": sum(m.status == "failed" for m in metrics),
        "failed_traces": sum(m.failed_traces for m in metrics),
        "slo": _slo_attainment(metrics),
    }


def _slo_attainment(metrics: Sequence[RequestMetrics]) -> dict:
    """SLO attainment over the requests that carry an objective. A shed
    request (every trace dropped by admission control, so it never
    produced a first token) counts as a TTFT miss — shedding is a
    capacity decision, not an excuse."""
    ttft_j = [m.ttft_attained for m in metrics
              if m.ttft_attained is not None]
    tpot_j = [m.tpot_attained for m in metrics
              if m.tpot_attained is not None]
    return {
        "requests_with_slo": sum(
            m.slo_ttft_s is not None or m.slo_tpot_s is not None
            for m in metrics),
        "ttft_attainment": (sum(ttft_j) / len(ttft_j)
                            if ttft_j else None),
        "tpot_attainment": (sum(tpot_j) / len(tpot_j)
                            if tpot_j else None),
    }


def summarize_by_tenant(metrics: Sequence[RequestMetrics],
                        ps: Sequence[float] = (50, 90, 99)) -> dict:
    """Per-tenant breakdown of ``summarize`` (the BENCH_slo.json
    payload): tenants are compared on the same percentile table, plus
    their SLO attainment."""
    tenants: Dict[str, list] = {}
    for m in metrics:
        tenants.setdefault(m.tenant, []).append(m)
    return {name: summarize(ms, ps) for name, ms in sorted(tenants.items())}


def _mean(xs: Sequence[float]) -> Optional[float]:
    """Mean, or ``None`` for an empty input (same NaN-avoidance
    rationale as ``percentiles``)."""
    return sum(xs) / len(xs) if xs else None
