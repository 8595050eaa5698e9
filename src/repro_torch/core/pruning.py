"""Pruning policies: STEP (ours) + the paper's baselines (§5.1).

The engine consults the active policy at three points each scheduler
step:

  * ``observe_pressure(pressure)``     — once per scheduler tick, the
    engine publishes the current admission pressure (queued requests,
    runnable-but-unadmitted traces, pool occupancy). Policies may use it
    to modulate pruning; the base implementation just records it.
  * ``traces_to_terminate(running)``   — signal-triggered early stopping
    (DeepConf confidence threshold, Slim-SC similarity pruning, STEP's
    optional proactive pruning under admission pressure);
  * ``on_memory_full(running, pressure=...)`` — invoked when the paged
    KV pool cannot schedule the next decode step. STEP returns the
    lowest-scored trace to prune (freeing its blocks immediately — the
    waiting queue never forms); baselines return None, which makes the
    engine PREEMPT a trace vLLM-style (free blocks, re-enqueue,
    recompute later).
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.core.voting import majority_vote, weighted_vote


@dataclasses.dataclass(frozen=True)
class AdmissionPressure:
    """What the scheduler can tell a policy about contention right now.

    Published once per tick (continuous batching: arrivals land while
    earlier requests still decode, so pruning decisions can react to how
    much work is knocking on the door, not just to the instant the pool
    runs dry — the online regime ReProbe / Tracing-the-Traces evaluate).
    """

    waiting_traces: int = 0     # runnable traces with no decode slot/blocks
    queued_requests: int = 0    # arrived requests not yet started
    free_blocks: int = 0
    total_blocks: int = 0
    # prefix-cache occupancy (0 with the cache off). Parked blocks are
    # NOT live-trace memory: the engine evicts them before consulting any
    # pruning policy (evict-before-prune), so policies must count
    # evictable cache blocks as headroom — otherwise cache occupancy
    # would trigger proactive pruning the cache-off engine never does.
    cached_blocks: int = 0      # blocks parked in the prefix-cache trie
    evictable_blocks: int = 0   # parked blocks only the cache references
    # multi-tenant view (None under the default FIFO scheduling policy):
    # waiting traces per tenant, and each tenant's remaining weighted
    # fair-share token deficit — a policy can prune harder for tenants
    # that are over budget (negative deficit) before the scheduler
    # preempts them.
    demand_by_tenant: Optional[Mapping[str, int]] = None
    deficit_by_tenant: Optional[Mapping[str, float]] = None
    # fault-degraded serving: True while the engine runs a persistent-
    # fault degrade rung (kernel->dense, horizon pin, fan-out shed). A
    # policy may prune more conservatively — degraded capacity is
    # transient, not a demand signal.
    degraded: bool = False
    # HBM bytes per KV block (pool storage + quantization scales; see
    # kv_quant.pool_block_bytes). 0 when the publisher didn't wire byte
    # accounting — the byte properties then report 0 and policies fall
    # back to block counts. With quantized pools the same block budget
    # costs ~4x fewer bytes, so byte-aware policies see the real HBM
    # picture instead of a dtype-blind block tally.
    bytes_per_block: int = 0

    @property
    def memory_utilization(self) -> float:
        if self.total_blocks <= 0:
            return 0.0
        return 1.0 - self.free_blocks / self.total_blocks

    @property
    def reclaimable_blocks(self) -> int:
        """Headroom the scheduler can produce without touching a live
        trace: the free list plus evict-before-prune cache blocks."""
        return self.free_blocks + self.evictable_blocks

    @property
    def demand(self) -> int:
        """Units of work contending for admission."""
        return self.waiting_traces + self.queued_requests

    @property
    def free_bytes(self) -> int:
        """Free-list HBM bytes (0 when byte accounting is unwired)."""
        return self.free_blocks * self.bytes_per_block

    @property
    def total_bytes(self) -> int:
        """Allocatable pool HBM bytes (excludes the scratch block)."""
        return self.total_blocks * self.bytes_per_block

    @property
    def reclaimable_bytes(self) -> int:
        """Byte view of :attr:`reclaimable_blocks`."""
        return self.reclaimable_blocks * self.bytes_per_block


class PruningPolicy:
    """Base: self-consistency behaviour (no pruning, preemption on OOM)."""

    name = "sc"
    uses_scorer = False
    last_pressure: Optional[AdmissionPressure] = None

    def observe_pressure(self, pressure: AdmissionPressure) -> None:
        """Scheduler-tick hook: record the current admission pressure."""
        self.last_pressure = pressure

    def observe_decode_burst(self, trace: Trace, tokens: Sequence[int],
                             confidences: Sequence[float],
                             step_scores: Sequence[float]) -> None:
        """Per-trace per-tick burst hook (decode horizon).

        With ``EngineConfig.decode_horizon`` K > 1 the engine emits up to
        K tokens per trace per scheduler tick; the burst (already
        appended to ``trace``) is handed over in one call instead of K
        one-at-a-time appends. Termination sweeps
        (``traces_to_terminate``) therefore run at horizon granularity:
        a policy reacting to a signal inside the burst can terminate the
        trace at the next sweep, at most K-1 tokens late. The base
        implementation records nothing; stateful policies may override
        to update incremental signal aggregates.
        """

    def traces_to_terminate(self, running: Sequence[Trace]) -> List[Trace]:
        return []

    def on_memory_full(self, running: Sequence[Trace],
                       pressure: Optional[AdmissionPressure] = None
                       ) -> Optional[Trace]:
        return None  # => engine preempts (waiting queue forms)

    def vote(self, traces: Sequence[Trace]) -> Optional[str]:
        return majority_vote([t.answer for t in traces])


class SelfConsistency(PruningPolicy):
    name = "sc"


class SingleTrace(PruningPolicy):
    """CoT baseline — the engine simply launches one trace."""
    name = "cot"


@dataclasses.dataclass
class StepPolicy(PruningPolicy):
    """STEP (ours): hidden-state step scores + memory-aware pruning +
    score-weighted voting.

    ``proactive_free_blocks`` (default 0 = off, the paper's setting):
    under continuous batching, prune the lowest-scored running trace
    *before* the pool actually runs dry — whenever admission pressure
    exists (waiting traces or queued requests) and the free pool has
    fallen below the margin. This trades a little trace budget for TTFT
    of queued arrivals; keep it 0 to reproduce the paper's reactive
    behaviour exactly. A trace is only judged proactively once it shows
    a step score or has decoded ``proactive_min_tokens`` tokens.
    """

    proactive_free_blocks: int = 0
    proactive_min_tokens: int = 16

    name = "step"
    uses_scorer = True

    def traces_to_terminate(self, running: Sequence[Trace]) -> List[Trace]:
        p = self.last_pressure
        if (self.proactive_free_blocks <= 0 or p is None
                or p.demand == 0
                or p.reclaimable_blocks >= self.proactive_free_blocks):
            return []
        cands = [t for t in running if t.alive
                 and (t.step_scores
                      or t.num_tokens >= self.proactive_min_tokens)]
        if len(cands) <= 1:
            return []
        return [min(cands, key=lambda t: t.score)]

    def on_memory_full(self, running: Sequence[Trace],
                       pressure: Optional[AdmissionPressure] = None
                       ) -> Optional[Trace]:
        candidates = [t for t in running if t.alive]
        if not candidates:
            return None
        return min(candidates, key=lambda t: t.score)

    def vote(self, traces: Sequence[Trace]) -> Optional[str]:
        return weighted_vote([t.answer for t in traces],
                             [t.score for t in traces])


@dataclasses.dataclass
class DeepConfPolicy(PruningPolicy):
    """DeepConf-low (Fu et al., 2025): warmup N_init traces offline, set the
    confidence threshold retaining the top ``keep_pct`` traces, terminate
    later traces falling below it; confidence-weighted vote."""

    warmup: int = 16
    keep_pct: float = 0.10
    min_tokens: int = 32  # don't judge traces before any signal exists

    name = "deepconf"
    uses_scorer = False

    def __post_init__(self):
        self.threshold: Optional[float] = None
        self._warmup_confs: List[float] = []

    def record_warmup(self, traces: Sequence[Trace]) -> None:
        self._warmup_confs = [t.confidence for t in traces]
        if self._warmup_confs:
            self.threshold = float(np.quantile(
                self._warmup_confs, 1.0 - self.keep_pct))

    def traces_to_terminate(self, running: Sequence[Trace]) -> List[Trace]:
        if self.threshold is None:
            return []
        return [t for t in running
                if t.num_tokens >= self.min_tokens
                and t.confidence < self.threshold]

    def vote(self, traces: Sequence[Trace]) -> Optional[str]:
        return weighted_vote([t.answer for t in traces],
                             [t.confidence for t in traces])


@dataclasses.dataclass
class SlimSCPolicy(PruningPolicy):
    """Slim-SC (Hong et al., 2025), Random-Pruning variant: periodically
    measure inter-trace similarity at the thought level and prune one of
    any pair above the threshold."""

    threshold: float = 0.95
    check_every: int = 64   # tokens between similarity sweeps
    ngram: int = 4
    seed: int = 0

    name = "slimsc"
    uses_scorer = False

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._last_check: dict = {}

    @staticmethod
    def _ngrams(tokens: List[int], n: int) -> set:
        return {tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1)}

    def similarity(self, a: Trace, b: Trace) -> float:
        ga = self._ngrams(a.output_tokens, self.ngram)
        gb = self._ngrams(b.output_tokens, self.ngram)
        if not ga or not gb:
            return 0.0
        return len(ga & gb) / len(ga | gb)

    def traces_to_terminate(self, running: Sequence[Trace]) -> List[Trace]:
        live = [t for t in running if t.alive and t.num_tokens
                >= self.check_every]
        due = [t for t in live if t.num_tokens
               - self._last_check.get(t.trace_id, 0) >= self.check_every]
        if not due:
            return []
        for t in live:
            self._last_check[t.trace_id] = t.num_tokens
        doomed: List[Trace] = []
        for i, a in enumerate(live):
            for b in live[i + 1:]:
                if a in doomed or b in doomed:
                    continue
                if self.similarity(a, b) > self.threshold:
                    doomed.append(self._rng.choice((a, b)))
        return doomed


def make_policy(name: str, **kw) -> PruningPolicy:
    table = {
        "cot": SingleTrace,
        "sc": SelfConsistency,
        "step": StepPolicy,
        "deepconf": DeepConfPolicy,
        "slimsc": SlimSCPolicy,
    }
    return table[name](**kw)
