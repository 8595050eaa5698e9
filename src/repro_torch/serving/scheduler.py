"""Event-driven scheduler core + pluggable scheduling policies.

This module is the host-side brain of ``Engine.serve_batch``: the
former monolithic tick loop, refactored into an explicit event loop
(``SchedulerCore``) over pluggable ``SchedulingPolicy`` objects, fully
decoupled from the device-step execution that stays in ``engine.py``
(the prefill / chunked-prefill / fused-decode / COW-copy steps,
which the core drives through the engine handle it is constructed
with).

Event loop
----------

Every state transition happens in an event handler; ``run`` is only the
pump that synthesizes the next event when the queue drains:

  * ``Arrival``          — the request queue released a request (its
    arrival time passed): its traces enter the waiting pool.
  * ``BudgetReplenish``  — a scheduling round begins: per-tick token
    budgets are replenished (weighted deficit round-robin under a
    tenant policy), DeepConf gates update, ``AdmissionPressure`` is
    published to every active pruning policy, and the admission wave
    runs (SLO admission control, chunked prefills, prefix forks).
  * ``ChunkDone``        — one chunked-prefill chunk landed on device.
  * ``BurstDone``        — the fused decode burst for this round
    synced back to the host: per-trace outputs/scores are folded in,
    EOS/limit lanes finish, signal-triggered termination sweeps run.
  * ``Completion``       — a request's last trace finished/pruned: its
    ``RequestResult`` is streamed to the ``on_complete`` callback.

Events are delivered FIFO and synchronously (the loop is
single-threaded and deterministic); with the default FIFO policy the
handler cascade executes the exact operation sequence of the old tick
loop, so the event core is token/score/prune-identical to it under a
fixed RNG (pinned in tests/test_scheduler.py).

With the engine's tracer on (``serving/tracing.py``), every event is an
instant of the trace, each round a ``round`` span from its
``BudgetReplenish`` to the end of its burst's fold, with a span for each
of its phases inside, and each round starts with a row of counters (the
pool's blocks, the lanes and queues, the horizon fallbacks).

Scheduling policies
-------------------

``FIFOPolicy`` (the default) reproduces the single-queue behaviour:
arrival-ordered admission, one global per-tick token budget
(``EngineConfig.max_tokens_per_step``), last-arrived preemption
victims, no SLO admission control.

``TenantScheduler`` adds SLO-aware multi-tenant serving on top of the
same core:

  * **weighted fair token budgets** — the per-tick token pool is dealt
    to tenants by weighted deficit round-robin (``DeficitRoundRobin``):
    every round each *active* tenant's deficit counter grows by its
    weight share of the pool, decode/prefill tokens are charged to the
    owning tenant, and admission stalls for tenants whose deficit ran
    dry. A lone tenant always holds the whole pool, so the policy
    degenerates to ``FIFOPolicy`` exactly.
  * **priority admission** — waiting traces are picked by
    ``(priority, deficit)`` (stable within a class, so equal-priority
    single-tenant batches keep FIFO order).
  * **SLO admission control** — when a request's projected TTFT
    (elapsed wait + prefill backlog over the observed token rate)
    violates its ``SLO``, the policy *degrades* its trace fan-out
    (sheds ``n_traces`` down to ``SLO.min_traces`` — STEP's
    test-time-scaling quality dial) or, with ``SLO.shed`` set, rejects
    the request outright.
  * **over-budget preemption** — when the pool is exhausted and the
    pruning policy declines (baselines), the preemption victim is the
    last-arrived running trace of the *most over-budget* tenant
    (lowest deficit), routed through the existing preempt/recompute
    and evict-before-prune machinery.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from collections import deque
from typing import (TYPE_CHECKING, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.pruning import AdmissionPressure, DeepConfPolicy
from repro_torch.core.trace import Trace, TraceStatus
from repro_torch.data.arithmetic import extract_answer
from repro_torch.serving.faults import DeviceStepFault, FatalFaultError
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.tracing import NULL_SPAN

if TYPE_CHECKING:  # engine imports scheduler; never the reverse at runtime
    from repro_torch.serving.engine import Engine, Request


@dataclasses.dataclass
class SharedPrefix:
    """Per-request artifact of the shared prompt prefill."""
    blocks: List[int]           # holder's own references (freed at req end)
    seq_len: int
    last_logits: torch.Tensor   # [1, Vp] vocab-masked last-position logits
    slot_state: Optional[tuple]  # (ssm, conv) end state for ssm/hybrid


# ---------------------------------------------------------------------------
# SLO + events
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service-level objective.

    ``ttft_s`` drives admission control under a ``TenantScheduler``:
    when the projected time-to-first-token exceeds it, the request's
    trace fan-out is degraded towards ``min_traces`` (quality for
    latency — the paper's dial), and with ``shed`` set a projection
    beyond ``shed_factor * ttft_s`` rejects the request outright (all
    traces shed, answer ``None``). ``tpot_s`` is an attainment target
    only (reported per tenant by ``metrics.summarize_by_tenant``, never
    enforced mid-decode).
    """

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    min_traces: int = 1
    shed: bool = False
    shed_factor: float = 4.0


@dataclasses.dataclass
class Event:
    """Base scheduler event (``t`` is seconds since the serve-loop
    start)."""
    t: float


@dataclasses.dataclass
class Arrival(Event):
    request_id: int
    n_traces: int


@dataclasses.dataclass
class BudgetReplenish(Event):
    tick: int
    budget_limit: Optional[int]   # None = unlimited


@dataclasses.dataclass
class ChunkDone(Event):
    request_id: int
    pos: int          # prompt tokens prefilled so far
    total: int        # prompt length
    chunk_tokens: int


@dataclasses.dataclass
class BurstDone(Event):
    tick: int
    n_lanes: int
    tokens: int       # emitted tokens across lanes this burst


@dataclasses.dataclass
class Completion(Event):
    request_id: int


@dataclasses.dataclass
class Cancelled(Event):
    """A request left the scheduler before finishing: released by
    ``Engine.cancel`` or by its ``Request.deadline`` expiring."""
    request_id: int
    reason: str       # "cancelled" | "deadline_exceeded"


# ---------------------------------------------------------------------------
# token budgets
# ---------------------------------------------------------------------------

class TokenBudget:
    """Per-round token budget (``EngineConfig.max_tokens_per_step``).

    Decode consumes one token per running trace per horizon iteration
    before prefill work is scheduled; ``spend`` charges prefill tokens
    when they are computed. ``force`` lets ``can`` approve the round's
    first prefill even beyond the limit when nothing is decoding —
    otherwise a prompt longer than the budget could never start.
    ``tenant`` is accepted (and ignored) so tenant-aware subclasses can
    charge per-tenant deficits through the same call sites.
    """

    def __init__(self, limit: Optional[int]):
        self.left = limit  # None = unlimited
        self.spent_any = False

    def can(self, n_tokens: int, force: bool = False,
            tenant: Optional[str] = None) -> bool:
        if self.left is None or self.left >= n_tokens:
            return True
        return force and not self.spent_any

    def spend(self, n_tokens: int, tenant: Optional[str] = None) -> None:
        self.spent_any = True
        if self.left is not None:
            self.left = max(self.left - n_tokens, 0)


class DeficitRoundRobin:
    """Weighted deficit round-robin over a shared token pool.

    Each ``replenish(active, pool)`` round deals ``pool`` tokens to the
    active tenants proportionally to their weights; ``charge`` spends a
    tenant's deficit (it may go negative when the core force-approves
    work, the standard DRR debt convention). Deficits are capped at
    ``burst_rounds`` full rounds of that tenant's quantum so an idle
    tenant cannot hoard unbounded credit.
    """

    def __init__(self, weights: Optional[Mapping[str, float]] = None,
                 default_weight: float = 1.0, burst_rounds: float = 4.0):
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self.burst_rounds = float(burst_rounds)
        self.deficit: Dict[str, float] = {}

    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    def reset(self) -> None:
        self.deficit.clear()

    def replenish(self, active: Sequence[str], pool: float) -> None:
        active = list(dict.fromkeys(active))  # de-dup, keep order
        total_w = sum(self.weight(t) for t in active)
        if total_w <= 0:
            return
        for t in active:
            quantum = pool * self.weight(t) / total_w
            cap = self.burst_rounds * max(quantum, pool / max(len(active), 1))
            self.deficit[t] = min(self.deficit.get(t, 0.0) + quantum, cap)

    def charge(self, tenant: str, n_tokens: float) -> None:
        self.deficit[tenant] = self.deficit.get(tenant, 0.0) - n_tokens

    def balance(self, tenant: str) -> float:
        return self.deficit.get(tenant, 0.0)


class WeightedTokenBudget(TokenBudget):
    """Global per-round budget + per-tenant DRR deficits.

    A spend is approved only when both the global pool and the owning
    tenant's deficit cover it (``force`` keeps the first-prefill escape
    hatch of the base class and may drive a deficit negative — DRR
    debt that later rounds repay)."""

    def __init__(self, limit: Optional[int], drr: DeficitRoundRobin):
        super().__init__(limit)
        self.drr = drr

    def can(self, n_tokens: int, force: bool = False,
            tenant: Optional[str] = None) -> bool:
        globally = self.left is None or self.left >= n_tokens
        fairly = tenant is None or self.drr.balance(tenant) >= n_tokens
        if globally and fairly:
            return True
        return force and not self.spent_any

    def spend(self, n_tokens: int, tenant: Optional[str] = None) -> None:
        super().spend(n_tokens)
        if tenant is not None:
            self.drr.charge(tenant, n_tokens)


# ---------------------------------------------------------------------------
# scheduling policies
# ---------------------------------------------------------------------------

class SchedulingPolicy:
    """Pluggable scheduler brain: admission order, per-round token
    budgets, SLO admission control and preemption victim selection.

    The base class IS the FIFO policy: its defaults reproduce the
    pre-refactor tick loop exactly (arrival-ordered admission, one
    global token budget, last-arrived preemption, no shedding), which
    is what pins the event core token-identical to it.
    """

    name = "fifo"

    def reset(self) -> None:
        """Called once per ``serve_batch`` run before any event."""

    def on_event(self, event: Event) -> None:
        """Observer hook: every scheduler event passes through here."""

    def tick_budget(self, core: "SchedulerCore") -> TokenBudget:
        """Budget for one scheduling round. Decode may emit up to
        ``decode_horizon`` tokens per running trace this round; they
        are charged pessimistically up front."""
        mts = core.ecfg.max_tokens_per_step
        limit = (None if mts is None
                 else max(mts - len(core.running) * core.K_cfg, 0))
        return TokenBudget(limit)

    def pick(self, core: "SchedulerCore", skipped: set) -> Optional[Trace]:
        """Next waiting trace to consider for admission (None = wave
        over). FIFO: first admissible trace in arrival order."""
        return next(
            (t for t in core.waiting
             if t.request_id not in skipped
             and core.by_req[t.request_id].admissible(t)), None)

    def target_traces(self, core: "SchedulerCore", st) -> int:
        """SLO admission control: how many traces this request may fan
        out into (checked once, at its first admission attempt).
        FIFO never sheds."""
        return len(st.traces)

    def preempt_victim(self, core: "SchedulerCore",
                       needy: Optional[Trace]) -> Optional[Trace]:
        """Running trace to preempt when memory is full and the pruning
        policy declined. ``None`` means the needy trace is the lone
        runner and must truncate-finish instead. FIFO/vLLM: the
        last-arrived running trace."""
        running = core.running
        victim = running[-1]
        if victim is needy:
            if len(running) == 1:
                return None
            victim = running[-2]
        return victim

    def pressure_extras(self, core: "SchedulerCore") -> dict:
        """Extra ``AdmissionPressure`` fields (tenant demand/deficits
        under a tenant policy; nothing for FIFO)."""
        return {}


class FIFOPolicy(SchedulingPolicy):
    """Alias of the base policy, for explicit construction."""


class TenantScheduler(SchedulingPolicy):
    """SLO-aware multi-tenant scheduling policy (see module docstring).

    ``weights`` maps tenant name -> fair-share weight (unknown tenants
    get ``default_weight``). With a single tenant, equal priorities and
    no SLOs this policy is behaviour-identical to ``FIFOPolicy`` —
    pinned by tests and by the ``REPRO_SCHED=tenant`` CI lane, which
    runs the whole engine suite through it.
    """

    name = "tenant"

    def __init__(self, weights: Optional[Mapping[str, float]] = None,
                 default_weight: float = 1.0, burst_rounds: float = 4.0):
        self.drr = DeficitRoundRobin(weights, default_weight=default_weight,
                                     burst_rounds=burst_rounds)

    def reset(self) -> None:
        self.drr.reset()

    # -- weighted fair budgets -------------------------------------------
    def tick_budget(self, core: "SchedulerCore") -> TokenBudget:
        mts = core.ecfg.max_tokens_per_step
        if mts is None:
            # unlimited pool: fairness acts through admission order only.
            # A plain unlimited budget (not a weighted one): deficits are
            # never replenished without a per-step pool, so gating on
            # them would starve every non-forced admission and diverge
            # from FIFO — the reduction contract this policy pins.
            return TokenBudget(None)
        self.drr.replenish(core.active_tenants(), mts)
        for trace in core.running:   # pessimistic decode charge
            self.drr.charge(core.tenant_of(trace.request_id), core.K_cfg)
        limit = max(mts - len(core.running) * core.K_cfg, 0)
        return WeightedTokenBudget(limit, self.drr)

    # -- priority + deficit admission order ------------------------------
    def pick(self, core: "SchedulerCore", skipped: set) -> Optional[Trace]:
        best, best_key = None, None
        for t in core.waiting:
            if t.request_id in skipped:
                continue
            st = core.by_req[t.request_id]
            if not st.admissible(t):
                continue
            key = (getattr(st.req, "priority", 0),
                   self.drr.balance(core.tenant_of(t.request_id)))
            if best is None or key > best_key:  # stable: first wins ties
                best, best_key = t, key
        return best

    # -- SLO admission control --------------------------------------------
    def target_traces(self, core: "SchedulerCore", st) -> int:
        n = len(st.traces)
        slo: Optional[SLO] = getattr(st.req, "slo", None)
        if slo is None or slo.ttft_s is None:
            return n
        now_rel = core._now_rel()
        waited = max(now_rel - st.req.arrival_time, 0.0)
        rate = core.token_rate()
        backlog = core.prefill_backlog_tokens() + len(st.req.prompt_tokens)
        projected = waited + (backlog / rate if rate > 0 else 0.0)
        if projected <= slo.ttft_s:
            return n
        if slo.shed and projected > slo.shed_factor * max(slo.ttft_s, 1e-9):
            return 0
        frac = slo.ttft_s / projected if projected > 0 else 0.0
        return max(min(slo.min_traces, n), int(n * frac))

    # -- over-budget preemption -------------------------------------------
    def preempt_victim(self, core: "SchedulerCore",
                       needy: Optional[Trace]) -> Optional[Trace]:
        candidates = [t for t in core.running if t is not needy]
        if not candidates:
            return None  # lone needy runner: truncate-finish
        # most over-budget tenant first (lowest deficit), last-arrived
        # within it (>= keeps the latest trace on ties — the FIFO victim)
        victim = candidates[0]
        victim_bal = self.drr.balance(core.tenant_of(victim.request_id))
        for t in candidates[1:]:
            bal = self.drr.balance(core.tenant_of(t.request_id))
            if bal <= victim_bal:
                victim, victim_bal = t, bal
        return victim

    def pressure_extras(self, core: "SchedulerCore") -> dict:
        demand: Dict[str, int] = {}
        for t in core.waiting:
            tenant = core.tenant_of(t.request_id)
            demand[tenant] = demand.get(tenant, 0) + 1
        return {"demand_by_tenant": demand,
                "deficit_by_tenant": dict(self.drr.deficit)}


def parse_tenant_weights(spec: str) -> Dict[str, float]:
    """Parse ``name:weight,name:weight`` (the ``--tenant-weights`` CLI
    syntax) into a weights mapping. A bare ``name`` means weight 1.0;
    malformed entries and non-positive weights raise ``ValueError``
    rather than silently becoming weight-1 tenants."""
    weights: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition(":")
        name = name.strip()
        if not name or "=" in name:
            raise ValueError(
                f"bad tenant spec {part!r}: expected NAME[:WEIGHT]")
        weight = float(w) if sep else 1.0  # float('') -> ValueError
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0, "
                             f"got {weight}")
        weights[name] = weight
    if not weights:
        raise ValueError(f"empty tenant-weights spec {spec!r}")
    return weights


def default_scheduler() -> Optional[SchedulingPolicy]:
    """Scheduler from the ``REPRO_SCHED`` env var: unset/"fifo" ->
    None (the engine builds a FIFOPolicy per run), "tenant" -> a
    TenantScheduler with default weights. The CI ``test-scheduler``
    lane sets ``REPRO_SCHED=tenant`` to run the whole engine suite
    through the tenant policy's FIFO-reduction path."""
    val = os.environ.get("REPRO_SCHED", "").strip().lower()
    if val in ("", "fifo", "none"):
        return None
    if val == "tenant":
        return TenantScheduler()
    raise ValueError(f"REPRO_SCHED must be 'fifo' or 'tenant', got {val!r}")


# ---------------------------------------------------------------------------
# per-request scheduler state
# ---------------------------------------------------------------------------

class ReqState:
    """Scheduler-side bookkeeping for one in-flight request."""

    def __init__(self, req: "Request", policy, traces: List[Trace],
                 sampling=None, max_new_tokens: Optional[int] = None):
        self.req = req
        self.policy = policy
        self.traces = traces
        # effective per-request generation knobs (engine defaults filled
        # in by serve_batch; None only until then)
        self.sampling = sampling
        self.max_new = max_new_tokens
        self.prefix: Optional[SharedPrefix] = None
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.t_done: Optional[float] = None
        self.warmup_recorded = not isinstance(policy, DeepConfPolicy)
        # prefix-cache accounting: one probe per request; a hit holds
        # forked block references until a PrefillJob takes them over
        self.cache_probed = False
        self.cache_hit: Optional[Tuple[List[int], int]] = None
        self.cached_tokens = 0
        # SLO admission control: checked once, at first admission attempt
        self.slo_checked = False
        self.degraded_traces = 0
        # online-serving timestamps (absolute perf_counter seconds)
        self.arrived = False
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.result = None           # Optional[RequestResult]
        # lifecycle outcome, copied onto RequestResult/RequestMetrics:
        # "completed" | "cancelled" | "deadline_exceeded" | "failed"
        self.final_status = "completed"

    @property
    def request_id(self) -> int:
        return self.req.request_id

    @property
    def tenant(self) -> str:
        return getattr(self.req, "tenant", "default") or "default"

    def note_first_token(self) -> None:
        if self.first_token_t is None:
            self.first_token_t = time.perf_counter()

    def admissible(self, trace: Trace) -> bool:
        """DeepConf online: traces beyond the warmup set wait until the
        warmup traces finished and the threshold exists."""
        if self.warmup_recorded:
            return True
        return trace.trace_id < self.policy.warmup

    def update_gate(self) -> None:
        if self.warmup_recorded:
            return
        warm = self.traces[:self.policy.warmup]
        if all(not t.alive for t in warm):
            self.policy.record_warmup(
                [t for t in warm if t.status == TraceStatus.FINISHED])
            self.warmup_recorded = True

    def done(self) -> bool:
        return all(not t.alive for t in self.traces)


class PrefillJob:
    """An in-flight chunked prompt prefill (shared-prefix path).

    Holds a chunk-granular block reservation: blocks already taken carry
    completed chunks' KV; the job draws more as chunks land and commits
    the full set into the request's ``SharedPrefix`` when the prompt is
    exhausted. ``abort`` (memory pressure) returns every block; the
    prefill restarts from scratch on the next admission attempt.

    A prefix-cache hit seeds the job with ``base_blocks`` (forked cached
    blocks covering the first ``base_tokens`` prompt tokens): the prefill
    starts at ``pos = base_tokens`` and only computes the suffix. Chunk
    boundaries stay on the absolute ``chunk``-token grid so the suffix
    chunks are the exact chunks a cold prefill would have run. ``eager``
    jobs (cache hit on an engine configured for one-shot prefill) run
    all their chunks in one round instead of interleaving with decode.
    """

    def __init__(self, st: ReqState, reservation, blocks_per_seq: int,
                 chunk: int, base_blocks: Sequence[int] = (),
                 base_tokens: int = 0, eager: bool = False):
        self.st = st
        self.tokens: List[int] = list(st.req.prompt_tokens)
        self.pos = base_tokens
        self.chunk = chunk
        self.eager = eager
        self.base: List[int] = list(base_blocks)
        self.res = reservation
        self.row = np.zeros((blocks_per_seq,), np.int32)
        self.row[:len(self.base)] = self.base
        self.last_logits = None

    @property
    def request_id(self) -> int:
        return self.st.request_id

    @property
    def done(self) -> bool:
        return self.pos >= len(self.tokens)

    def abort(self) -> None:
        self.res.abort()
        if self.base:
            # drop the forked cache references; the cached blocks stay
            # parked in the trie. The restart prefills from scratch, so
            # the request's hit accounting is rolled back too.
            self.res.mgr.free(self.base)
            self.base = []
            self.st.cached_tokens = 0


# ---------------------------------------------------------------------------
# the event-driven core
# ---------------------------------------------------------------------------

class SchedulerCore:
    """One ``serve_batch`` run: event pump + handlers over the engine's
    device steps.

    The core owns all scheduling state (queues, slots, block tables,
    budgets); the engine owns the device state (params, KV pools, device
    steps, the RNG) and exposes it through the handle passed here —
    ``eng._prefill`` / ``eng._chunk_prefill`` / ``eng.decode_fn`` /
    ``eng._copy_block`` / ``eng.sample_host(_lanes)`` plus the block
    manager and prefix cache. The split is what makes scheduling
    policies pluggable without touching device code.
    """

    def __init__(self, eng: "Engine", states: List[ReqState],
                 t_start: float,
                 on_complete: Optional[Callable] = None,
                 sched: Optional[SchedulingPolicy] = None):
        self.eng = eng
        self.ecfg = eng.ecfg
        self.cfg = eng.cfg
        self.tok = eng.tok
        self.states = states
        self.t_start = t_start
        self.on_complete = on_complete
        self.sched = sched if sched is not None else FIFOPolicy()
        self.sched.reset()

        ecfg, cfg = self.ecfg, self.cfg
        self.B = ecfg.max_batch
        self.bs = cfg.kv_block_size
        self.cap = ecfg.capacity
        self.share = ecfg.share_prompt_prefix
        self.chunk = (ecfg.prefill_chunk_size
                      if eng._chunk_supported else None)
        self.mgr = eng.block_mgr
        self.pcache = eng.prefix_cache
        self.K_cfg = ecfg.decode_horizon

        self.by_req: Dict[int, ReqState] = {st.request_id: st
                                            for st in states}
        assert len(self.by_req) == len(states), \
            "duplicate request_id in batch"
        self.pending = RequestQueue([st.req for st in states])
        self.started: List[ReqState] = []

        B, bps = self.B, eng.blocks_per_seq
        self.block_tables = np.zeros((B, bps), np.int32)
        self.positions = np.zeros((B,), np.int32)
        self.cur_tokens = np.zeros((B,), np.int32)
        # Device-resident mirrors of the decode-state arrays. The host
        # copies above stay authoritative for scheduling math; the
        # device copies are re-uploaded only when a host-side event
        # (admission, COW/frontier repoint, release) dirties them.
        self.dev = {"tokens": None, "positions": None, "block_tables": None}
        self.dirty = {"tokens": True, "positions": True,
                      "block_tables": True}
        # per-lane sampling params: only uploaded (and only consumed by
        # the lane-wise decode step) when any request in the batch
        # overrides the engine-global SamplingParams
        sp = ecfg.sampling
        self.mixed_sampling = any(st.sampling != sp for st in states)
        self.samp = {
            "temperature": np.full((B,), sp.temperature, np.float32),
            "top_k": np.full((B,), sp.top_k, np.int32),
            "top_p": np.full((B,), sp.top_p, np.float32),
        }
        self.samp_dev = None
        self.samp_dirty = True

        self.free_slots = list(range(B))
        self.running: List[Trace] = []
        self.waiting: List[Trace] = []
        self.jobs: Dict[int, PrefillJob] = {}  # request_id -> prefill

        self.cache = eng._take_kv_cache()
        self.peak_blocks = 0
        self.idle_ticks = 0   # consecutive no-progress rounds
        self.tick = 0
        self._tokens_done = 0  # prefill + decode tokens (rate estimate)

        # fault tolerance: the engine's injection plan (None = no
        # injection), recovery policy, and cumulative stats ledger
        self.plan = eng.fault_plan
        self.recovery = eng.recovery
        self.stats = eng.fault_stats
        self._alloc_stalls = 0    # consecutive allocator-stalled rounds
        self._fanout_shed = False  # persistent-alloc shed rung taken

        self.events: deque = deque()
        self.tr = eng.tracer
        self._round = NULL_SPAN

    # -- policy-facing views ------------------------------------------------
    def tenant_of(self, request_id: int) -> str:
        return self.by_req[request_id].tenant

    def active_tenants(self) -> List[str]:
        return [st.tenant for st in self.started if not st.done()]

    def token_rate(self) -> float:
        """Observed engine token rate (prefill + decode tokens per
        second since the loop started); 0.0 before any signal exists so
        SLO projections never act on a cold estimate."""
        if self._tokens_done < 1:
            return 0.0
        return self._tokens_done / max(self._now_rel(), 1e-6)

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens arrived but not yet prefilled (SLO projection
        input)."""
        total = 0
        for st in self.started:
            if st.done() or st.prefix is not None:
                continue
            pos = (self.jobs[st.request_id].pos
                   if st.request_id in self.jobs else 0)
            total += max(len(st.req.prompt_tokens) - pos, 0)
        return total

    # -- event plumbing -----------------------------------------------------
    def emit(self, event: Event) -> None:
        self.events.append(event)

    def _notify(self, event: Event) -> None:
        if self.tr.enabled:
            self.tr.event(event)
        self.sched.on_event(event)

    def _now_rel(self) -> float:
        """Seconds since the run began: the one clock reading that
        scheduling decisions act on (arrivals, deadlines, SLO
        projections). A mesh engine agrees it across its ranks
        (``Engine.agreed_clock``); timestamps kept only for metrics read
        ``time.perf_counter`` directly."""
        return self.eng.agreed_clock(time.perf_counter() - self.t_start)

    def has_work(self) -> bool:
        return bool(self.pending or self.waiting or self.running
                    or self.jobs)

    # ------------------------------------------------------------------
    # the pump
    # ------------------------------------------------------------------
    def run(self) -> int:
        """Pump events until every request completes. Returns the
        pool-wide peak block usage."""
        handlers = {
            Arrival: self._on_arrival,
            BudgetReplenish: self._on_budget_replenish,
            ChunkDone: self._on_chunk_done,
            BurstDone: self._on_burst_done,
            Completion: self._on_completion,
            Cancelled: self._on_cancelled,
        }
        while True:
            if not self.events:
                if not self.has_work():
                    break
                self._pump()
                continue
            event = self.events.popleft()
            self._notify(event)
            try:
                handlers[type(event)](event)
            except FatalFaultError:
                # retries and every degrade rung exhausted: fail the
                # remaining requests, drain the pool, keep the engine
                # usable — the loop then exits with no work left
                self.abort_serve()
                self.tr.end(self._round)

        for job in list(self.jobs.values()):  # defensive: no job survives
            job.abort()
        self.jobs.clear()
        for st in self.states:  # defensive: no prefix may outlive its batch
            self.release_prefix(st)
        self.eng._stash_kv_cache(self.cache)
        return self.peak_blocks

    def _pump(self) -> None:
        """Synthesize the next event: released arrivals first, then a
        scheduling round if anything is runnable, otherwise sleep until
        the next arrival is due."""
        now_rel = self._now_rel()
        if self._sweep_cancellations(now_rel):
            return
        arrived = self.pending.pop_arrived(now_rel)
        if arrived:
            for req in arrived:
                self.emit(Arrival(t=now_rel, request_id=req.request_id,
                                  n_traces=req.n_traces))
            return
        if self.waiting or self.running or self.jobs:
            mts = self.ecfg.max_tokens_per_step
            self.tick += 1
            self.emit(BudgetReplenish(t=now_rel, tick=self.tick,
                                      budget_limit=mts))
            return
        nxt = self.pending.next_arrival()
        if nxt is not None:
            with self.tr.span("await_arrival"):
                time.sleep(min(max(nxt - now_rel, 0.0), 0.02) + 1e-4)

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------
    def _on_arrival(self, ev: Arrival) -> None:
        st = self.by_req[ev.request_id]
        st.arrived = True
        self.started.append(st)
        for t in st.traces:
            t.status = TraceStatus.WAITING
            # wait_time counts only MEMORY-induced waiting (paper
            # Table 3): the clock starts at preemption or at a
            # memory-blocked admission attempt, not at arrival.
            t.runnable_since = -1.0
        self.waiting.extend(st.traces)

    def _on_completion(self, ev: Completion) -> None:
        st = self.by_req[ev.request_id]
        if self.on_complete is not None and st.result is not None:
            self.on_complete(st.result)

    def _on_chunk_done(self, ev: ChunkDone) -> None:
        self._tokens_done += ev.chunk_tokens

    def _on_budget_replenish(self, ev: BudgetReplenish) -> None:
        """One scheduling round, traced as a ``round`` span that the
        burst's fold ends (or the round itself, if it dispatched none)."""
        tr = self.tr
        self._round = tr.span("round", tick=ev.tick,
                              running=len(self.running))
        if tr.enabled:
            self._trace_counters()
        if not self._run_round(ev):
            tr.end(self._round)

    def _trace_counters(self) -> None:
        """The round's counters: the pool's blocks by holder, the lanes
        and queues, the horizon fallbacks so far."""
        mgr, pcache = self.mgr, self.pcache
        reserved = sum(j.res.num_taken for j in self.jobs.values())
        cached = pcache.cached_blocks if pcache is not None else 0
        self.tr.counter("pool", held=mgr.used_blocks - reserved - cached,
                        reserved=reserved, cached=cached,
                        free=mgr.free_blocks)
        self.tr.counter("queue", running=len(self.running),
                        waiting=len(self.waiting),
                        queued=len(self.pending))
        self.tr.counter("horizon_fallbacks",
                        count=self.eng.horizon_fallbacks)

    def _run_round(self, ev: BudgetReplenish) -> bool:
        """Gates -> pressure -> admission wave -> write-block assurance
        -> decode dispatch. Returns True if it dispatched a burst."""
        if self.plan is not None and self.plan.alloc_blocked(ev.tick):
            # injected allocator outage: STALL the whole round (no
            # admission, no decode) instead of reaching the memory-
            # pressure machinery — a transient outage must not shift
            # prune/preempt decisions, so survivors stay bit-identical.
            # Persistent outages degrade (shed fan-out) and then abort.
            self.stats.alloc_faults += 1
            self._alloc_stalls += 1
            if self._alloc_stalls == self.recovery.shed_after:
                self.shed_fanout()
                self.audit()
            if self._alloc_stalls >= self.recovery.abort_after:
                raise FatalFaultError(
                    f"allocator unavailable for {self._alloc_stalls} "
                    f"consecutive rounds")
            time.sleep(self.recovery.backoff(self._alloc_stalls))
            return False
        self._alloc_stalls = 0
        with self.tr.span("pressure"):
            for st in self.started:
                st.update_gate()
            pressure = self.current_pressure()
            for st in self.started:
                if not st.done():
                    st.policy.observe_pressure(pressure)

        budget = self.sched.tick_budget(self)
        with self.tr.span("admit"):
            progressed = self.try_admit(budget)
        if not self.running:
            if not (self.waiting or self.jobs or self.pending):
                return False
            if progressed:
                self.idle_ticks = 0
                return False
            if self.pending:
                # arrivals still due: wait for them (not a deadlock)
                nxt = self.pending.next_arrival()
                now_rel = self._now_rel()
                if nxt is not None and nxt > now_rel:
                    with self.tr.span("await_arrival"):
                        time.sleep(min(nxt - now_rel, 0.02) + 1e-4)
                return False
            self.idle_ticks += 1
            if self.idle_ticks >= 3:
                raise RuntimeError("no trace schedulable")
            return False
        self.idle_ticks = 0
        return self._dispatch_decode(ev)

    # ------------------------------------------------------------------
    # pool accounting + memory pressure (ported from the tick loop)
    # ------------------------------------------------------------------
    def note_peak(self) -> None:
        self.peak_blocks = max(self.peak_blocks, self.mgr.used_blocks)

    def release_prefix(self, st: ReqState, park: bool = True) -> None:
        """Drop the request's shared-prefix holder references. With
        the prefix cache on, the prompt's full blocks are parked in
        the trie for cross-request reuse instead of freed; the
        partial tail block (written by this request's own prefill)
        is never shared and always returns to the pool. ``park=False``
        (memory reclaim) frees everything outright."""
        if st.prefix is None:
            return
        blocks, n_tok = st.prefix.blocks, st.prefix.seq_len
        st.prefix = None
        if park and self.pcache is not None and n_tok >= self.bs:
            n_full = n_tok // self.bs
            self.pcache.insert(st.req.prompt_tokens, blocks[:n_full])
            if blocks[n_full:]:
                self.mgr.free(blocks[n_full:])
        else:
            self.mgr.free(blocks)

    def evict_for(self, n: int) -> bool:
        """Free-list headroom for ``n`` blocks, reclaiming LRU
        prefix-cache blocks on demand — parked KV is the cheapest
        memory in the pool (a reuse opportunity, not live compute),
        so it always goes before any trace is pruned/preempted."""
        if self.mgr.can_allocate(n):
            return True
        if self.pcache is not None:
            freed = self.pcache.evict(n - self.mgr.free_blocks)
            if freed:
                self.tr.instant("evict", blocks=freed)
        return self.mgr.can_allocate(n)

    def release(self, trace: Trace, status: TraceStatus) -> None:
        if trace.blocks:
            self.mgr.free(trace.blocks)
            trace.blocks = []
        if trace.batch_slot >= 0:
            s = trace.batch_slot
            self.block_tables[s, :] = self.mgr.scratch_block
            self.positions[s] = 0
            self.dirty["block_tables"] = self.dirty["positions"] = True
            self.cache = self.eng._clear_slot_state(self.cache, s)
            self.free_slots.append(s)
            trace.batch_slot = -1
        trace.status = status
        if trace in self.running:
            self.running.remove(trace)
        st = self.by_req[trace.request_id]
        if st.done():
            self.release_prefix(st)
            if st.t_done is None:
                st.t_done = time.perf_counter()
            if st.result is None:
                st.result = self.eng._finalize(st, self.t_start, st.t_done,
                                               self.peak_blocks)
                self.emit(Completion(t=self._now_rel(),
                                     request_id=st.request_id))

    def reclaim_idle_prefix(self, skip_rid: int) -> bool:
        """Free shared-prefix blocks of requests with no running
        trace (their waiting traces recompute on readmission). Never
        touches ``skip_rid``: freeing the needy request's own prefix
        would report progress while undoing its admission work (an
        admit/prefill livelock)."""
        before = self.mgr.free_blocks
        live = {t.request_id for t in self.running}
        live.add(skip_rid)
        for st in self.started:
            if st.prefix is not None and st.request_id not in live:
                # reclaim must FREE, not park: parking would report
                # no free-list progress and fall through to
                # preemption with reusable blocks still held
                self.release_prefix(st, park=False)
        return self.mgr.free_blocks > before

    def abort_other_jobs(self, skip_rid: int) -> bool:
        """Cancel other requests' in-flight chunked prefills, freeing
        their partially-reserved blocks (they restart later). Only
        the decode path calls this — admission-time aborts could
        livelock two prefilling requests against each other."""
        freed = False
        for rid in list(self.jobs):
            if rid != skip_rid and self.jobs[rid].res.num_taken > 0:
                self.jobs.pop(rid).abort()
                freed = True
        return freed

    def current_pressure(self) -> AdmissionPressure:
        pcache = self.pcache
        return AdmissionPressure(
            waiting_traces=len(self.waiting),
            queued_requests=len(self.pending),
            free_blocks=self.mgr.free_blocks,
            total_blocks=self.ecfg.num_blocks - 1,
            cached_blocks=(pcache.cached_blocks
                           if pcache is not None else 0),
            evictable_blocks=(pcache.evictable_blocks
                              if pcache is not None else 0),
            degraded=(self.eng.force_horizon1 or self._fanout_shed
                      or self.stats.degraded_to_dense > 0),
            bytes_per_block=self.mgr.bytes_per_block,
            **self.sched.pressure_extras(self))

    def handle_memory_full(self, needy: Optional[Trace], rid: int,
                           at_admission: bool = False) -> bool:
        """Pool has no free block. Returns True if progress was made.

        STEP: the needy request's policy prunes its lowest-scored
        running trace, freeing its blocks — the waiting queue never
        forms.
        Baselines: at admission the new trace simply WAITS (vLLM does
        not evict running work for new arrivals); mid-decode the
        scheduling policy picks a running victim to PREEMPT
        (discard-and-recompute) into the waiting queue — last-arrived
        under FIFO, the most over-budget tenant's last trace under a
        TenantScheduler.
        """
        # evict-before-prune: LRU cache-only blocks are reclaimed
        # before any live trace is touched. This ordering is what
        # keeps cache-on scheduling a superset of cache-off headroom
        # (the cache can only ADD free-able memory, never displace a
        # trace that would have run with the cache off).
        if self.pcache is not None and self.pcache.evict(1):
            self.tr.instant("evict", rid=rid, blocks=1)
            return True
        st = self.by_req[rid]
        own_running = [t for t in self.running if t.request_id == rid]
        victim = st.policy.on_memory_full(own_running,
                                          pressure=self.current_pressure())
        if victim is not None:  # STEP prune
            if len(own_running) <= 1 and needy is victim:
                # sole survivor: finish (truncate) instead of self-prune
                self.tr.instant("truncate", rid=rid)
                self.finish(victim)
                return True
            if self.tr.enabled:
                scores = [t.score for t in own_running if t.alive]
                self.tr.instant(
                    "prune", rid=rid, score=victim.score, least=min(scores),
                    candidates=len(scores),
                    at="admission" if at_admission else "decode")
            self.release(victim, TraceStatus.PRUNED)
            return True
        if self.reclaim_idle_prefix(skip_rid=rid):
            return True
        if at_admission or not self.running:
            return False  # baseline: queue the arrival, keep decoding
        if self.abort_other_jobs(skip_rid=rid):
            return True
        victim = self.sched.preempt_victim(self, needy)
        if victim is None:
            # lone trace cannot be preempted to help itself: truncate
            self.tr.instant("truncate", rid=rid)
            self.finish(needy)
            return True
        self.tr.instant("preempt", rid=victim.request_id)
        self.release(victim, TraceStatus.PREEMPTED)
        victim.runnable_since = time.perf_counter()
        self.waiting.append(victim)
        return True

    def finish(self, trace: Trace) -> None:
        text = self.tok.decode(trace.output_tokens)
        trace.answer = extract_answer(text)
        self.release(trace, TraceStatus.FINISHED)

    # ------------------------------------------------------------------
    # fault tolerance: cancellation, retry/degrade, recovery
    # ------------------------------------------------------------------
    def _sweep_cancellations(self, now_rel: float) -> bool:
        """Fire ``Cancelled`` events for requests flagged by
        ``Engine.cancel`` and for requests past their deadline (arrived
        or still pending). Runs at the top of every pump iteration;
        returns True if anything was emitted so the events are handled
        before the next scheduling round."""
        fired = False
        for rid in list(self.eng._cancel_requests):
            self.eng._cancel_requests.discard(rid)
            st = self.by_req.get(rid)
            if st is not None and st.result is None:
                self.emit(Cancelled(t=now_rel, request_id=rid,
                                    reason="cancelled"))
                fired = True
        for st in self.states:
            ddl = getattr(st.req, "deadline", None)
            if ddl is not None and st.result is None and now_rel >= ddl:
                self.emit(Cancelled(t=now_rel, request_id=st.request_id,
                                    reason="deadline_exceeded"))
                fired = True
        return fired

    def _on_cancelled(self, ev: Cancelled) -> None:
        st = self.by_req[ev.request_id]
        if st.result is not None:
            return  # finished between the sweep and delivery
        if ev.reason == "deadline_exceeded":
            self.stats.deadline_exceeded += 1
        else:
            self.stats.cancelled += 1
        self.release_request(st, ev.reason)
        self.audit()

    def release_request(self, st: ReqState, status: str,
                        trace_status: TraceStatus = TraceStatus.CANCELLED
                        ) -> None:
        """The single release path for cancellation/deadline/failure:
        the request's traces, decode slots, prefill reservation,
        cache-hit forks and prefix references all return to the pool,
        and its result is finalized with ``status``. Traces already
        FINISHED keep their output (a deadline'd request still votes
        over whatever completed in time)."""
        st.final_status = status
        if not st.arrived:
            # still pending: withdraw from the arrival queue and
            # finalize immediately (no pool state exists yet)
            self.pending.remove(st.request_id)
            st.arrived = True
            for t in st.traces:
                t.status = trace_status
            st.t_done = time.perf_counter()
            st.result = self.eng._finalize(st, self.t_start, st.t_done,
                                           self.peak_blocks)
            self.emit(Completion(t=self._now_rel(),
                                 request_id=st.request_id))
            return
        job = self.jobs.pop(st.request_id, None)
        if job is not None:
            job.abort()
        if st.cache_hit is not None:
            self.mgr.free(st.cache_hit[0])
            st.cache_hit = None
        for t in list(st.traces):
            if not t.alive:
                continue
            if t in self.waiting:
                self.waiting.remove(t)
            self.release(t, trace_status)

    def shed_fanout(self) -> None:
        """Persistent-alloc degrade rung: shed WAITING trace fan-out
        down to each request's SLO floor (``slo.min_traces``, else 1).
        Mirrors ``apply_slo_admission`` — running lanes are never
        touched, so survivors stay bit-identical."""
        self._fanout_shed = True
        for st in self.started:
            if st.done():
                continue
            slo = getattr(st.req, "slo", None)
            keep = max(slo.min_traces if slo is not None else 1, 1)
            excess = sum(1 for t in st.traces if t.alive) - keep
            for t in reversed(st.traces):
                if excess <= 0:
                    break
                if t.status == TraceStatus.WAITING and t in self.waiting:
                    self.waiting.remove(t)
                    self.tr.instant("prune", rid=st.request_id, at="shed")
                    self.release(t, TraceStatus.PRUNED)
                    st.degraded_traces += 1
                    self.stats.shed_traces += 1
                    excess -= 1

    def abort_serve(self) -> None:
        """Recovery exhausted: fail every unfinished request through
        the normal release path, leaving the pool drained and the
        engine reusable. The event loop exits cleanly afterwards."""
        self.stats.aborted += 1
        for st in self.states:
            if st.result is None:
                self.release_request(st, "failed",
                                     trace_status=TraceStatus.FAILED)
        self.waiting.clear()
        self.audit()

    def emergency_drain(self) -> None:
        """Mid-serve crash cleanup (``serve_batch`` re-raises after):
        abort reservations, free every live trace's blocks and prefix
        holders, and drop the device pool — a crash mid-device-call may
        leave the in-place-updated pool half written, so parked KV cannot
        be trusted.
        The next serve starts from a freshly initialized, drained pool.
        """
        for job in list(self.jobs.values()):
            job.abort()
        self.jobs.clear()
        for st in self.states:
            if st.cache_hit is not None:
                self.mgr.free(st.cache_hit[0])
                st.cache_hit = None
            for t in st.traces:
                if not t.alive:
                    continue
                if t.blocks:
                    self.mgr.free(t.blocks)
                    t.blocks = []
                if t.batch_slot >= 0:
                    self.free_slots.append(t.batch_slot)
                    t.batch_slot = -1
                t.status = TraceStatus.FAILED
            if st.result is None:
                st.final_status = "failed"
            if st.prefix is not None:
                self.mgr.free(st.prefix.blocks)
                st.prefix = None
        self.running.clear()
        self.waiting.clear()
        if self.pcache is not None:
            self.pcache.clear()   # parked KV may point into a dead pool
        self.eng._kv_cache = None  # next serve re-inits the device pool

    def audit(self) -> None:
        """Invariant audit after a fault/cancel path: allocator
        refcount conservation and no reservations open beyond the
        in-flight prefill jobs' own."""
        self.eng.check_integrity(expect_open_reservations=len(self.jobs))

    def degrade_step(self) -> bool:
        """Take the next persistent-step-fault degrade rung. Every rung
        is token-identical by the engine's equivalence pins: kernel ==
        dense first, then decode_horizon K == 1. Returns
        False when the ladder is exhausted."""
        if self.eng.degrade_to_dense():
            return True
        if self.K_cfg > 1 and not self.eng.force_horizon1:
            self.eng.force_horizon1 = True
            self.stats.degraded_horizon += 1
            return True
        return False

    def device_call(self, thunk: Callable):
        """Run one device step under the fault plan's step injection and
        the retry/degrade recovery policy.

        Injected ``DeviceStepFault``s are raised BEFORE the device call,
        so no RNG is consumed and the KV pool is untouched — a retry is
        bit-identical to the un-faulted call. ``thunk`` is zero-arg and
        re-resolves the engine's step on each attempt, so a mid-ladder
        degrade (kernel->dense rebuild, the horizon pin) takes effect on
        the very next retry. Real exceptions propagate immediately (the
        pool is updated in place, so a blind retry is unsafe); recovery
        exhaustion raises ``FatalFaultError``.
        """
        attempts = 0
        faulted = False
        while True:
            try:
                if self.plan is not None:
                    self.plan.maybe_step_fault(self.tick)
                out = thunk()
            except DeviceStepFault:
                faulted = True
                attempts += 1
                self.stats.step_faults += 1
                if attempts <= self.recovery.retry_limit:
                    self.stats.step_retries += 1
                    time.sleep(self.recovery.backoff(attempts))
                    continue
                if self.degrade_step():
                    attempts = 0
                    continue
                raise FatalFaultError(
                    "device step still failing after retries and every "
                    "degrade rung") from None
            if faulted:
                self.stats.recovered_steps += 1
            return out

    # ------------------------------------------------------------------
    # write-block assurance (COW / frontier)
    # ------------------------------------------------------------------
    def owns_write_block(self, trace: Trace, bidx: int) -> bool:
        return (bidx < len(trace.blocks)
                and not self.mgr.is_shared(trace.blocks[bidx]))

    def claim_write_block(self, trace: Trace, bidx: int) -> None:
        """Make ``trace`` the exclusive owner of its write block at
        ``bidx``: a fresh block at the growth frontier, or a COW
        copy of a still-shared (prompt) block — the first private
        write, or a window wrap re-entering shared blocks. The
        caller has ensured a free block exists."""
        blk = self.mgr.allocate(1)
        self.note_peak()
        if bidx < len(trace.blocks):
            old = trace.blocks[bidx]
            try:
                with self.tr.span("block_copy", rid=trace.request_id):
                    self.cache = self.eng._copy_block(self.cache, old,
                                                      blk[0])
            except BaseException:
                self.mgr.free(blk)   # the fresh block must not leak
                raise
            self.mgr.free([old])
            trace.blocks[bidx] = blk[0]
        else:
            trace.blocks.extend(blk)
        self.block_tables[trace.batch_slot, bidx] = blk[0]
        self.dirty["block_tables"] = True

    def max_new(self, trace: Trace) -> int:
        """Per-request max-new-tokens override (engine default when the
        request does not set one)."""
        return self.by_req[trace.request_id].max_new

    def frontier_walk(self, trace: Trace, k_tick: int):
        """Yield (token offset j, block index) over ``trace``'s
        next-``k_tick``-token write window, beyond the next token
        (whose block the COW/grow pass already guarantees)."""
        p = int(self.positions[trace.batch_slot])
        want = min(k_tick,
                   max(self.max_new(trace) - trace.num_tokens, 1))
        for j in range(1, want):
            yield j, ((p + j) % self.cap) // self.bs

    def extend_frontier(self, trace: Trace, k_tick: int) -> int:
        """Secure exclusively-owned write blocks for up to
        ``k_tick`` upcoming tokens of one trace. Best-effort: a
        short free list shortens the lane's horizon, it never
        triggers pruning/preemption."""
        secured = 1
        for j, bidx in self.frontier_walk(trace, k_tick):
            if not self.owns_write_block(trace, bidx):
                if not self.evict_for(1):
                    break
                self.claim_write_block(trace, bidx)
            secured = j + 1
        return secured

    def start_wait_clock(self, st: ReqState) -> None:
        """Memory-blocked before admission: start the WAIT clock of
        the request's next admissible trace (mirrors the one-shot
        path, which stamps the admitting trace)."""
        for t in st.traces:
            if t.status == TraceStatus.WAITING and t in self.waiting:
                if t.runnable_since < 0:
                    t.runnable_since = time.perf_counter()
                return

    # ------------------------------------------------------------------
    # admission (chunked prefill jobs, shared prefix, private path)
    # ------------------------------------------------------------------
    def advance_job(self, job: PrefillJob, budget: TokenBudget) -> str:
        """Run prefill chunks for one job within the round budget.

        Returns "ready" (prefix complete), "budget" (round budget or
        interleave cap reached), or "memory" (blocked on blocks with
        no reclaimable progress).
        """
        eng = self.eng
        st = job.st
        tenant = st.tenant
        L = len(job.tokens)
        C = job.chunk
        base_n = len(job.base)
        while not job.done:
            # stay on the absolute C-token chunk grid: a cache-hit
            # suffix (pos starts at base_tokens) runs the exact
            # chunks a cold prefill of this prompt would have run
            c = min(C - job.pos % C, L - job.pos)
            if not budget.can(c, force=not self.running, tenant=tenant):
                return "budget"
            need_total = self.mgr.blocks_for_tokens(job.pos + c)
            need_new = need_total - base_n - job.res.num_taken
            while need_new > 0:
                got = job.res.take(need_new)
                if got is not None:
                    self.note_peak()
                    start = base_n + job.res.num_taken - len(got)
                    job.row[start : base_n + job.res.num_taken] = got
                    break
                self.start_wait_clock(st)
                if not self.handle_memory_full(None, st.request_id,
                                               at_admission=True):
                    return "memory"
            t_pf = time.perf_counter()
            toks = np.zeros((1, C), np.int32)
            toks[0, :c] = job.tokens[job.pos : job.pos + c]
            pos_arr = job.pos + np.arange(C, dtype=np.int32)[None, :]
            valid = (np.arange(C, dtype=np.int32)[None, :] < c)
            with self.tr.span("prefill_chunk", rid=st.request_id,
                              tokens=c, pos=job.pos):
                logits, self.cache = self.device_call(
                    lambda: eng._chunk_prefill(
                        eng.params, self.cache, eng.to_device(toks),
                        eng.to_device(pos_arr), eng.to_device(valid),
                        eng.to_device(job.row[None, :])))
            job.last_logits = logits[:, c - 1]
            job.pos += c
            budget.spend(c, tenant=tenant)
            st.prefill_s += time.perf_counter() - t_pf
            self.emit(ChunkDone(t=self._now_rel(),
                                request_id=st.request_id,
                                pos=job.pos, total=L, chunk_tokens=c))
            if self.running and not job.eager:
                # interleave: while traces decode, at most one chunk
                # per round so prefill never stalls the decode batch
                break
        if job.done:
            base, job.base = job.base, []
            st.prefix = SharedPrefix(
                blocks=base + job.res.commit(), seq_len=L,
                last_logits=job.last_logits, slot_state=None)
            self.jobs.pop(st.request_id, None)
            return "ready"
        return "budget"

    def ensure_prefix(self, st: ReqState, trace: Trace,
                      budget: TokenBudget) -> Optional[bool]:
        """Build the request's shared prompt prefill on demand
        (one-shot path; the chunked path goes through PrefillJob).

        True: prefix ready. False: memory action made progress, retry
        admission. None: memory full and nothing to free — queue.
        """
        eng = self.eng
        if st.prefix is not None:
            return True
        seq_len = len(trace.prompt_tokens)
        need = self.mgr.blocks_for_tokens(seq_len)
        # need + 1: the admitting trace's first private (COW) block
        # must fit too, or the headroom check right after us fails
        # and the just-computed prefill is wasted (worst case: an
        # endless build/reclaim/rebuild cycle)
        if not self.evict_for(need + 1):
            if trace.runnable_since < 0:
                trace.runnable_since = time.perf_counter()
            if not self.handle_memory_full(None, st.request_id,
                                           at_admission=True):
                return None
            return False
        budget.spend(seq_len, tenant=st.tenant)
        blocks = self.mgr.allocate(need)
        self.note_peak()
        row = np.zeros((eng.blocks_per_seq,), np.int32)
        row[:len(blocks)] = blocks
        t_pf = time.perf_counter()
        with self.tr.span("prefill", rid=st.request_id, tokens=seq_len):
            ids_arr = eng.to_device(
                np.array(trace.prompt_tokens, np.int32)[None, :])
            try:
                logits, kvs = self.device_call(
                    lambda: eng._prefill(eng.params, ids_arr))
            except BaseException:
                self.mgr.free(blocks)   # the local holding must not leak
                raise
            attn_kvs, slot_state = eng._split_prefill_kvs(kvs)
            self.cache = eng._write_prefix_kv(self.cache, attn_kvs, row,
                                              seq_len)
        st.prefix = SharedPrefix(blocks=blocks, seq_len=seq_len,
                                 last_logits=logits[:, -1],
                                 slot_state=slot_state)
        st.prefill_s += time.perf_counter() - t_pf
        self._tokens_done += seq_len
        return True

    def admit_shared(self, trace: Trace, st: ReqState,
                     wave: List[Trace]) -> None:
        """Fork the request's prompt blocks into a fresh trace."""
        prefix = st.prefix
        self.waiting.remove(trace)
        slot = self.free_slots.pop(0)
        if trace.runnable_since >= 0:
            trace.wait_time += time.perf_counter() - trace.runnable_since
            trace.runnable_since = -1.0
        trace.blocks = self.mgr.fork(prefix.blocks)
        trace.batch_slot = slot
        trace.status = TraceStatus.RUNNING
        trace.prefill_count += 1
        self.running.append(trace)
        if st.admit_t is None:
            st.admit_t = time.perf_counter()
        row = np.zeros((self.eng.blocks_per_seq,), np.int32)
        row[:len(trace.blocks)] = trace.blocks
        self.block_tables[slot] = row
        self.positions[slot] = prefix.seq_len
        self.dirty["block_tables"] = self.dirty["positions"] = True
        self._set_slot_sampling(slot, st)
        if prefix.slot_state is not None:
            self.cache = self.eng._write_slot_state(self.cache,
                                                    prefix.slot_state, slot)
        wave.append(trace)

    def admit_private(self, trace: Trace, st: ReqState) -> None:
        """Original per-trace path: full prefill into private blocks
        (flag off, prompt > capacity, or preempted-trace recompute)."""
        eng = self.eng
        ids = trace.prompt_tokens + trace.output_tokens
        need = self.mgr.blocks_for_tokens(min(len(ids) + 1, self.cap))
        self.waiting.remove(trace)
        blocks = self.mgr.allocate(need)
        self.note_peak()
        slot = self.free_slots.pop(0)
        if trace.runnable_since >= 0:
            trace.wait_time += time.perf_counter() - trace.runnable_since
            trace.runnable_since = -1.0
        trace.blocks = blocks
        trace.batch_slot = slot
        trace.status = TraceStatus.RUNNING
        trace.prefill_count += 1
        self.running.append(trace)
        if st.admit_t is None:
            st.admit_t = time.perf_counter()

        row = np.zeros((eng.blocks_per_seq,), np.int32)
        row[:len(blocks)] = blocks
        self.block_tables[slot] = row
        t_pf = time.perf_counter()
        with self.tr.span("prefill", rid=st.request_id, tokens=len(ids)):
            ids_arr = eng.to_device(np.array(ids, np.int32)[None, :])
            # trace.blocks/slot are already registered, so a fatal abort
            # from here releases them through the normal trace path
            logits, kvs = self.device_call(
                lambda: eng._prefill(eng.params, ids_arr))
            cache_new = eng._write_prefill(self.cache, kvs, slot, row,
                                           len(ids))
        # next token continues from the last prefill logit
        self.positions[slot] = len(ids)
        self.dirty["block_tables"] = self.dirty["positions"] = True
        self.dirty["tokens"] = True
        self._set_slot_sampling(slot, st)
        with self.tr.span("first_tokens", rid=st.request_id):
            with self.tr.device("first_tokens"):
                nt, conf = eng.sample_host(logits[:, -1], st.sampling)
            self.cur_tokens[slot] = int(nt[0])
            trace.output_tokens.append(int(nt[0]))
            trace.token_confidences.append(float(conf[0]))
        st.note_first_token()
        self.cache = cache_new
        st.prefill_s += time.perf_counter() - t_pf
        self._tokens_done += len(ids)

    def _set_slot_sampling(self, slot: int, st: ReqState) -> None:
        if not self.mixed_sampling:
            return
        sp = st.sampling
        self.samp["temperature"][slot] = sp.temperature
        self.samp["top_k"][slot] = sp.top_k
        self.samp["top_p"][slot] = sp.top_p
        self.samp_dirty = True

    def flush_first_tokens(self, wave: List[Trace]) -> None:
        """Batch the first-token sampling for every trace admitted via
        prefix forking in this admission wave (one device call)."""
        live = [t for t in wave if t.status == TraceStatus.RUNNING]
        if not live:
            return
        with self.tr.span("first_tokens", traces=len(live)):
            with self.tr.device("first_tokens"):
                logits = torch.cat(
                    [self.by_req[t.request_id].prefix.last_logits
                     for t in live], dim=0)  # [m, Vp]
                if self.mixed_sampling:
                    sps = [self.by_req[t.request_id].sampling for t in live]
                    nt, conf = self.eng.sample_host_lanes(logits, sps)
                else:
                    nt, conf = self.eng.sample_host(logits,
                                                    self.ecfg.sampling)
            nt = nt.cpu().tolist()
            conf = conf.cpu().tolist()
        self.dirty["tokens"] = True
        for i, trace in enumerate(live):
            self.cur_tokens[trace.batch_slot] = nt[i]
            trace.output_tokens.append(nt[i])
            trace.token_confidences.append(conf[i])
            self.by_req[trace.request_id].note_first_token()

    def apply_slo_admission(self, st: ReqState) -> bool:
        """SLO admission control, once per request at its first
        admission attempt: the scheduling policy may degrade the trace
        fan-out (shed waiting traces — STEP's quality dial) or reject
        the request outright. Returns True if any trace was shed."""
        if st.slo_checked:
            return False
        st.slo_checked = True
        target = self.sched.target_traces(self, st)
        own_waiting = [t for t in st.traces
                       if t.status == TraceStatus.WAITING
                       and t in self.waiting]
        excess = own_waiting[max(target, 0):]
        if not excess:
            return False
        st.degraded_traces = len(excess)
        for t in excess:
            self.waiting.remove(t)
            self.tr.instant("prune", rid=st.request_id, at="slo")
            self.release(t, TraceStatus.PRUNED)
        return True

    def try_admit(self, budget: TokenBudget) -> bool:
        """One admission wave. Returns True if anything was admitted
        or any prefill chunk advanced."""
        wave: List[Trace] = []
        advanced = False
        n_private = n_jobs = 0   # admissions by full prefill, jobs advanced
        # in-flight chunked prefills advance first (oldest work)
        for rid in list(self.jobs):
            job = self.jobs.get(rid)
            if job is None:
                continue
            before = job.pos
            status = self.advance_job(job, budget)
            if status == "ready" or job.pos > before:
                advanced = True
                n_jobs += 1
        skipped: set = set()
        while self.free_slots:
            trace = self.sched.pick(self, skipped)
            if trace is None:
                break
            st = self.by_req[trace.request_id]
            if self.apply_slo_admission(st):
                advanced = True
                continue  # re-pick: the shed may have emptied the queue
            tenant = st.tenant
            # sharing needs prompt blocks + one private block to ever
            # fit the pool; pathologically small pools fall back to
            # the per-trace path (which can truncate-finish)
            prefix_fits = (self.mgr.blocks_for_tokens(
                len(trace.prompt_tokens)) + 1 <= self.ecfg.num_blocks - 1)
            fresh = (self.share and not trace.output_tokens
                     and len(trace.prompt_tokens) <= self.cap
                     and prefix_fits)
            if fresh:
                L = len(trace.prompt_tokens)
                if (st.prefix is None and self.pcache is not None
                        and not st.cache_probed):
                    # probe the prefix cache exactly once per request
                    # (stats stay deterministic across re-picks) and
                    # pin the hit immediately: the fork's refcounts
                    # protect the matched blocks from eviction while
                    # the request waits for a slot or budget
                    st.cache_probed = True
                    hit_blocks, hit_tokens = self.pcache.match(
                        trace.prompt_tokens)
                    if hit_blocks:
                        st.cache_hit = (self.mgr.fork(hit_blocks),
                                        hit_tokens)
                        st.cached_tokens = hit_tokens
                use_job = st.prefix is None and (
                    st.request_id in self.jobs
                    or st.cache_hit is not None
                    or (self.chunk is not None and L > self.chunk))
                if use_job:
                    # chunked path: open/advance the prefill job; the
                    # trace admits once the prefix completes. Cache
                    # hits always take this path — the suffix runs as
                    # block-size chunks (a fixed chunk shape) even on
                    # engines configured for one-shot prefill.
                    job = self.jobs.get(st.request_id)
                    if job is None:
                        base, base_tokens = st.cache_hit or ([], 0)
                        st.cache_hit = None
                        job = PrefillJob(
                            st,
                            self.mgr.reserve(self.mgr.blocks_for_tokens(L)
                                             - len(base)),
                            self.eng.blocks_per_seq,
                            chunk=(self.chunk if self.chunk is not None
                                   else self.bs),
                            base_blocks=base, base_tokens=base_tokens,
                            eager=self.chunk is None)
                        self.jobs[st.request_id] = job
                    before = job.pos
                    status = self.advance_job(job, budget)
                    if status == "ready" or job.pos > before:
                        n_jobs += 1
                    if status == "ready":
                        advanced = True
                        continue  # re-pick: prefix now exists
                    if job.pos > before:
                        advanced = True
                    if status == "memory":
                        break
                    skipped.add(st.request_id)
                    continue
                if st.prefix is None and not budget.can(
                        L, force=not self.running, tenant=tenant):
                    skipped.add(st.request_id)
                    continue
                ok = self.ensure_prefix(st, trace, budget)
                if ok is None:
                    break
                if ok is False:
                    continue
                # the admitted trace decodes THIS round — up to a
                # full horizon of tokens: charge them pessimistically
                # so a round never exceeds the budget
                if not budget.can(self.K_cfg,
                                  force=not self.running and not wave,
                                  tenant=tenant):
                    skipped.add(st.request_id)
                    continue
                # headroom for this trace's first private block (the
                # COW copy of the prompt's tail block, or a fresh
                # block when the prompt ends exactly on a boundary)
                if not self.evict_for(1):
                    if trace.runnable_since < 0:
                        trace.runnable_since = time.perf_counter()
                    if not self.handle_memory_full(None, st.request_id,
                                                   at_admission=True):
                        break
                    continue
                budget.spend(self.K_cfg, tenant=tenant)
                self.admit_shared(trace, st, wave)
            else:
                ids_len = (len(trace.prompt_tokens)
                           + len(trace.output_tokens))
                # prefill cost + this round's decode horizon
                if not budget.can(ids_len + self.K_cfg,
                                  force=not self.running, tenant=tenant):
                    skipped.add(trace.request_id)
                    continue
                need = self.mgr.blocks_for_tokens(
                    min(ids_len + 1, self.cap))
                if not self.evict_for(need):
                    # memory full at admission: STEP prunes,
                    # baselines wait
                    if trace.runnable_since < 0:
                        trace.runnable_since = time.perf_counter()
                    if not self.handle_memory_full(None, st.request_id,
                                                   at_admission=True):
                        break
                    if not self.evict_for(need):
                        break
                    continue
                budget.spend(ids_len + self.K_cfg, tenant=tenant)
                self.admit_private(trace, st)
                n_private += 1
        self.flush_first_tokens(wave)
        self.tr.annotate(traces=len(wave) + n_private, jobs=n_jobs)
        return advanced or bool(wave)

    # ------------------------------------------------------------------
    # decode dispatch + burst processing
    # ------------------------------------------------------------------
    def _dispatch_decode(self, ev: BudgetReplenish) -> bool:
        """Write-block assurance, horizon selection, ONE fused device
        call, then a ``BurstDone`` event carrying the host-synced
        results. Returns False if no trace was left to decode."""
        eng, tr = self.eng, self.tr
        write_blocks = tr.span("write_blocks")
        # ensure every running trace exclusively owns the block its
        # next token's KV will be written into: allocate fresh blocks
        # at the growth frontier, copy-on-write still-shared (prompt)
        # blocks
        progress = True
        for trace in list(self.running):
            if trace.status != TraceStatus.RUNNING:
                # released (pruned/preempted) as an earlier trace's
                # memory-full victim within this very loop: it no
                # longer needs a write block, and raising pressure
                # on its behalf would evict a live trace for nothing
                continue
            pos = int(self.positions[trace.batch_slot])
            bidx = (pos % self.cap) // self.bs  # writes land at pos % window
            if self.owns_write_block(trace, bidx):
                continue
            while not self.evict_for(1):
                if not self.handle_memory_full(trace, trace.request_id):
                    progress = False
                    break
                if trace.status != TraceStatus.RUNNING:
                    break  # the needy trace itself was pruned/preempted
            if trace.status != TraceStatus.RUNNING or not progress:
                continue
            self.claim_write_block(trace, bidx)
        if not self.running:
            tr.end(write_blocks)
            return False

        # decode horizon: how many tokens may this round fuse?
        K_cfg = self.K_cfg
        K_tick = K_cfg
        if K_cfg > 1 and self.waiting:
            # Admission pressure: count the blocks a full-horizon
            # frontier would actually ALLOCATE (most rounds the write
            # block has unwritten slots left and the answer is 0 —
            # the horizon is free). If extending would drain the
            # free list to the last block, pre-allocation could
            # starve waiting admissions and shift memory-triggered
            # pruning decisions away from their horizon=1 points:
            # fall back to a single-token round until the contention
            # clears.
            needed_new = 0
            for trace in self.running:
                needed_new += len(
                    {bidx for _, bidx in self.frontier_walk(trace, K_cfg)
                     if not self.owns_write_block(trace, bidx)})
            if needed_new and not self.evict_for(needed_new + 1):
                eng.horizon_fallbacks += 1
                K_tick = 1
        if eng.force_horizon1:
            # persistent-fault degrade rung: every burst runs at K=1
            # (token-identical by the K==1 equivalence pin)
            K_tick = 1

        B = self.B
        limits = np.zeros((B,), np.int32)
        for trace in self.running:
            limits[trace.batch_slot] = (
                1 if K_tick == 1 else self.extend_frontier(trace, K_tick))
        tr.end(write_blocks)
        self._round.set(horizon=K_tick, fallback=K_tick < K_cfg)

        # one fixed-shape fused decode call: K_tick iterations of
        # decode + on-device sampling + step-boundary score capture
        n_by_req: Dict[int, int] = {}
        for t in self.running:
            n_by_req[t.request_id] = n_by_req.get(t.request_id, 0) + 1
        t_dec = time.perf_counter()
        upload = tr.span("upload")
        for name, arr in (("tokens", self.cur_tokens),
                          ("positions", self.positions),
                          ("block_tables", self.block_tables)):
            if self.dirty[name] or self.dev[name] is None:
                self.dev[name] = eng.to_device(arr)
                self.dirty[name] = False
        limits_dev = eng.to_device(limits)
        extra = ()
        if self.mixed_sampling:
            if self.samp_dirty or self.samp_dev is None:
                self.samp_dev = tuple(eng.to_device(self.samp[k]) for k in
                                      ("temperature", "top_k", "top_p"))
                self.samp_dirty = False
            extra = self.samp_dev
        tr.end(upload)

        def decode_thunk():
            # re-resolve the step each attempt: a mid-retry degrade
            # (kernel->dense rebuild, horizon pin) must take effect on
            # the next attempt. A K>1 limits row is valid for a K=1
            # step — the lane simply emits one token. On a CUDA engine
            # the step is one graph replay; it copies these tensors into
            # its static inputs first.
            K_eff = 1 if eng.force_horizon1 else K_tick
            fn = eng.decode_fn(K_eff if K_eff == K_cfg else 1,
                               lanewise=self.mixed_sampling)
            return fn(eng.params, self.cache, self.dev["tokens"],
                      self.dev["positions"], limits_dev,
                      self.dev["block_tables"], eng._rng,
                      eng.scorer_params, *extra)

        K_eff = 1 if eng.force_horizon1 else K_tick
        decode = tr.span("decode", horizon=K_eff if K_eff == K_cfg else 1,
                         lanewise=self.mixed_sampling)
        (toks_d, confs_d, scores_d, tv_d, sv_d, fin_tok, fin_pos,
         self.cache, eng._rng) = self.device_call(decode_thunk)
        tr.end(decode)
        # one host-transfer burst per round (the first .cpu() waits for
        # the device, the rest copy); .tolist() batches the per-trace
        # float()/int() conversions of the old per-token loop
        with tr.span("sync"):
            toks_h, confs_h, scores_h, tv_h, sv_h, ft_h, fp_h = (
                x.cpu().tolist() for x in
                (toks_d, confs_d, scores_d, tv_d, sv_d, fin_tok, fin_pos))
        tr.anchor()   # the stream is empty: tie the device's clock here
        if tr.enabled:
            decode.set(**self._lane_iterations(tv_h))
        if self.plan is not None:
            # NaN injection poisons the victim lane's HOST-synced
            # confidences only — device state is untouched, so the
            # other lanes are trivially unperturbed. The quarantine
            # path in _on_burst_done detects and terminates the lane.
            lanes = sorted((t.batch_slot, t.request_id)
                           for t in self.running)
            for slot in self.plan.nan_victims(ev.tick, lanes):
                confs_h[slot] = [float("nan")] * len(confs_h[slot])
        # These are a decode graph's static outputs, which its next
        # replay (or another key's graph, sharing its memory pool)
        # overwrites. Handing them back as the next tick's inputs is safe:
        # a graph copies its inputs into its own buffers before it
        # replays, and nothing else reads them.
        self.dev["tokens"], self.dev["positions"] = fin_tok, fin_pos
        self.cur_tokens[:] = ft_h
        self.positions[:] = fp_h
        dt = time.perf_counter() - t_dec
        tot = sum(n_by_req.values())
        for rid, n in n_by_req.items():
            self.by_req[rid].decode_s += dt * n / tot

        self._burst = (toks_h, confs_h, scores_h, tv_h, sv_h)
        self.emit(BurstDone(t=self._now_rel(), tick=ev.tick,
                            n_lanes=len(self.running), tokens=0))
        return True

    def _lane_iterations(self, tv_h: list) -> dict:
        """The burst's live lane-iterations and the summed length they
        attended over (lane b's iteration k over its position at the
        burst's start + k + 1 slots, at most the window), from the host's
        copy of its token-valid rows; the positions are those before the
        fold moves them."""
        valid = np.cumprod(np.asarray(tv_h, dtype=bool), axis=1)
        k = np.arange(valid.shape[1])
        length = np.minimum(self.positions[:, None] + k + 1, self.cap)
        return {"live": int(valid.sum()), "ctx": int((length * valid).sum())}

    def _on_burst_done(self, ev: BurstDone) -> None:
        """The burst's ``fold``, which ends the round's span."""
        with self.tr.span("fold"):
            self._fold(ev)
        if self.tr.enabled:
            self.tr.counter("burst", tokens=ev.tokens)
        self.tr.end(self._round)

    def _fold(self, ev: BurstDone) -> None:
        """Fold the synced burst into traces: outputs, scores, EOS /
        max-new-token finishes, then the signal-triggered termination
        sweep (DeepConf / Slim-SC / STEP proactive pruning)."""
        toks_h, confs_h, scores_h, tv_h, sv_h = self._burst
        emitted = 0
        quarantined = False
        for trace in list(self.running):
            st = self.by_req[trace.request_id]
            slot = trace.batch_slot
            valid_row = tv_h[slot]
            n_emit = 0
            for v in valid_row:
                if not v:
                    break
                n_emit += 1
            # NaN/Inf quarantine: a poisoned burst (injected or a real
            # numerical blow-up) must never fold into trace state —
            # terminate the lane with a distinct status; the other
            # lanes' device state never saw it
            bad = any(not math.isfinite(c) for c in confs_h[slot][:n_emit])
            if not bad and st.policy.uses_scorer:
                bad = any(not math.isfinite(scores_h[slot][i])
                          for i in range(n_emit) if sv_h[slot][i])
            if bad:
                self.stats.nan_quarantined += 1
                quarantined = True
                self.release(trace, TraceStatus.FAILED)
                continue
            # scores belong to the hidden states of the iteration
            # INPUT tokens; score_valid marks the step boundaries
            # (input token == step_id) inside the emitted prefix
            if st.policy.uses_scorer:
                burst_scores = [scores_h[slot][i]
                                for i in range(n_emit) if sv_h[slot][i]]
                if burst_scores:
                    trace.add_step_scores(burst_scores)
            else:
                burst_scores = []
            burst_toks = toks_h[slot][:n_emit]
            burst_confs = confs_h[slot][:n_emit]
            trace.extend_output(burst_toks, burst_confs)
            emitted += n_emit
            st.policy.observe_decode_burst(trace, burst_toks,
                                           burst_confs, burst_scores)
            if n_emit and (burst_toks[-1] == self.tok.eos_id
                           or trace.num_tokens >= st.max_new):
                self.finish(trace)
        ev.tokens = emitted
        self._tokens_done += emitted
        if quarantined:
            self.audit()

        # signal-triggered termination (DeepConf / Slim-SC / STEP
        # proactive pruning under admission pressure)
        for st in self.started:
            own = [t for t in self.running
                   if t.request_id == st.request_id]
            if not own:
                continue
            for trace in st.policy.traces_to_terminate(own):
                if trace.status == TraceStatus.RUNNING:
                    self.tr.instant("prune", rid=st.request_id, at="signal")
                    self.release(trace, TraceStatus.PRUNED)
