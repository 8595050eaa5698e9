"""Trace state: running step-score aggregation (paper §4.3).

score_t = (1/n) * sum_i y_hat_i — the running mean over step scores, chosen
over the latest-step score because it "captures the evolution of reasoning
quality across steps and is less sensitive to individual step variance".
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence


class TraceStatus(enum.Enum):
    WAITING = "waiting"        # queued, not yet prefilled
    RUNNING = "running"
    PREEMPTED = "preempted"    # baseline engines: KV freed, awaiting resume
    PRUNED = "pruned"          # STEP: terminated by policy
    FINISHED = "finished"
    CANCELLED = "cancelled"    # released by Engine.cancel / deadline
    FAILED = "failed"          # quarantined (NaN burst) or fatal fault


@dataclasses.dataclass
class Trace:
    trace_id: int
    request_id: int
    prompt_tokens: List[int]
    status: TraceStatus = TraceStatus.WAITING
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    step_scores: List[float] = dataclasses.field(default_factory=list)
    # token-level confidence (DeepConf baseline signal)
    token_confidences: List[float] = dataclasses.field(default_factory=list)
    answer: Optional[str] = None
    # engine bookkeeping
    batch_slot: int = -1
    blocks: List[int] = dataclasses.field(default_factory=list)
    # latency accounting (seconds)
    wait_time: float = 0.0
    decode_time: float = 0.0
    prefill_count: int = 0     # >1 means preemption-induced recompute
    runnable_since: float = 0.0  # timestamp when last became schedulable

    def add_step_score(self, s: float) -> None:
        self.step_scores.append(float(s))

    def add_step_scores(self, scores: Sequence[float]) -> None:
        """Burst append: one scheduler tick may close several reasoning
        steps when the engine decodes a multi-token horizon."""
        self.step_scores.extend(float(s) for s in scores)

    def extend_output(self, tokens: Sequence[int],
                      confidences: Sequence[float]) -> None:
        """Burst append of decoded tokens + their confidences (one call
        per scheduler tick instead of one per token)."""
        assert len(tokens) == len(confidences)
        self.output_tokens.extend(int(t) for t in tokens)
        self.token_confidences.extend(float(c) for c in confidences)

    @property
    def score(self) -> float:
        """Running mean of step scores; 0.5 (uninformative) before the
        first boundary so fresh traces are not unfairly pruned."""
        if not self.step_scores:
            return 0.5
        return sum(self.step_scores) / len(self.step_scores)

    @property
    def confidence(self) -> float:
        if not self.token_confidences:
            return 1.0
        return sum(self.token_confidences) / len(self.token_confidences)

    @property
    def num_tokens(self) -> int:
        return len(self.output_tokens)

    @property
    def total_len(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def alive(self) -> bool:
        return self.status in (TraceStatus.WAITING, TraceStatus.RUNNING,
                               TraceStatus.PREEMPTED)
