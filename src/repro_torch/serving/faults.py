"""Deterministic fault injection + recovery policy for the serving stack.

The engine's determinism pins (kernel==dense, K==1, cache on==off, mesh==
single) are also its recovery levers: a degraded engine produces the SAME
tokens, so fault handling can be tested bit-exactly. This module supplies
the *plan* (what to inject, when), the *policy* (how many retries, when to
degrade or abort), and the *ledger* (what happened); the scheduler core
owns the actual retry/degrade control flow.

Fault taxonomy (see docs/ENGINE.md "Failure handling"):

  * ``step``  — a simulated device-step failure (kernel dispatch error).
    Raised BEFORE the device call so no RNG is consumed and the KV
    cache is untouched; a retry is therefore bit-identical. Transient
    runs are absorbed by capped-backoff retries; persistent runs walk
    the degrade ladder (kernel→dense, decode_horizon K→1) and finally
    abort the serve.
  * ``alloc`` — the block allocator reports "full" for a window of
    scheduler rounds. The core stalls the round (no admission, no
    decode) rather than invoking memory-pressure pruning, so transient
    shortages leave surviving lanes bit-identical; persistent shortages
    shed trace fan-out via the SLO degrade machinery and finally abort.
  * ``nan``   — one lane's host-synced confidences are poisoned with NaN
    after the device call (device state untouched). The quarantine path
    in ``_on_burst_done`` terminates the lane with ``TraceStatus.FAILED``
    and the other lanes never see it.

Plans are seeded and replayable: ``FaultPlan.reset()`` re-arms every spec,
and the scheduler core calls it at the start of each serve, so the same
plan perturbs every serve of an engine identically.

Spec-string grammar (``--faults`` / ``REPRO_FAULTS``)::

    plan  := spec ("," spec)*
    spec  := kind "@" tick ["x" count] [":" key "=" value]
    kind  := "step" | "alloc" | "nan"
    key   := "req" | "slot"

Examples: ``step@3`` (one step fault at tick >= 3), ``step@3x5`` (five
consecutive failed attempts — enough to exhaust retries and trigger one
degrade rung), ``alloc@4x2`` (allocator reports full during ticks 4-5),
``nan@6:req=1`` (poison request 1's first running lane at tick 6).
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence


class DeviceStepFault(RuntimeError):
    """An injected, retryable device-step failure."""


class FatalFaultError(RuntimeError):
    """Recovery exhausted: retries and every degrade rung failed."""


_KINDS = ("step", "alloc", "nan")


@dataclasses.dataclass
class FaultSpec:
    """One injection trigger.

    ``tick`` arms the spec once the scheduler clock reaches it; ``count``
    is the number of firings (``step``/``nan``) or the width of the
    blocked-tick window (``alloc``). ``slot``/``request_id`` narrow a
    ``nan`` fault to a victim lane; with neither, the plan's seeded RNG
    picks among the running lanes.
    """

    kind: str
    tick: int
    count: int = 1
    slot: Optional[int] = None
    request_id: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if self.tick < 0 or self.count < 1:
            raise ValueError(f"fault spec needs tick >= 0 and count >= 1, "
                             f"got tick={self.tick} count={self.count}")


def _parse_spec(text: str) -> FaultSpec:
    head, _, opt = text.partition(":")
    kind, at, when = head.partition("@")
    if not at:
        raise ValueError(f"bad fault spec {text!r}: expected kind@tick")
    when, _, mult = when.partition("x")
    try:
        tick = int(when)
        count = int(mult) if mult else 1
    except ValueError:
        raise ValueError(f"bad fault spec {text!r}: tick/count must be "
                         f"integers") from None
    slot = request_id = None
    if opt:
        key, eq, val = opt.partition("=")
        if not eq or key not in ("req", "slot"):
            raise ValueError(f"bad fault spec {text!r}: option must be "
                             f"req=<id> or slot=<n>")
        try:
            if key == "req":
                request_id = int(val)
            else:
                slot = int(val)
        except ValueError:
            raise ValueError(f"bad fault spec {text!r}: {key} must be an "
                             f"integer") from None
    return FaultSpec(kind=kind.strip(), tick=tick, count=count,
                     slot=slot, request_id=request_id)


@dataclasses.dataclass
class RecoveryConfig:
    """Retry/degrade/abort policy knobs (engine defaults)."""

    retry_limit: int = 3          # failed attempts absorbed per ladder rung
    backoff_base_s: float = 0.001
    backoff_cap_s: float = 0.02
    shed_after: int = 2           # consecutive alloc-stalled rounds -> shed
    abort_after: int = 8          # consecutive alloc-stalled rounds -> abort

    def backoff(self, attempt: int) -> float:
        """Capped exponential backoff for the ``attempt``-th failure."""
        return min(self.backoff_base_s * (2 ** max(attempt - 1, 0)),
                   self.backoff_cap_s)


@dataclasses.dataclass
class FaultStats:
    """Ledger of injections and recovery actions over an engine lifetime."""

    step_faults: int = 0          # injected step failures observed
    step_retries: int = 0         # retries issued (<= step_faults)
    recovered_steps: int = 0      # device calls that succeeded after >=1 fault
    degraded_to_dense: int = 0    # kernel -> dense ladder rung taken
    degraded_horizon: int = 0     # decode_horizon K -> 1 rung taken
    alloc_faults: int = 0         # rounds stalled by injected alloc failure
    shed_traces: int = 0          # fan-out shed by the persistent-alloc rung
    nan_quarantined: int = 0      # lanes terminated by NaN/Inf quarantine
    cancelled: int = 0            # requests released via Engine.cancel
    deadline_exceeded: int = 0    # requests released via Request.deadline
    aborted: int = 0              # serves aborted after recovery exhaustion
    integrity_audits: int = 0     # check_integrity sweeps run

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class FaultPlan:
    """A seeded, replayable schedule of fault injections.

    The plan is consulted by the scheduler core at its device boundaries:
    ``maybe_step_fault`` before each prefill/chunk-prefill/decode call,
    ``alloc_blocked`` at the top of each budget round, ``nan_victims``
    after each decode burst's host sync. ``reset`` re-arms everything so
    the identical perturbation replays on the next serve.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self.reset()

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from the ``--faults``/``REPRO_FAULTS`` grammar."""
        specs = [_parse_spec(part.strip())
                 for part in text.split(",") if part.strip()]
        if not specs:
            raise ValueError(f"empty fault plan {text!r}")
        return cls(specs, seed=seed)

    def reset(self) -> None:
        """Re-arm every spec (called at the start of each serve)."""
        self._remaining: List[int] = [s.count for s in self.specs]
        self._rng = random.Random(self.seed)

    # -- step faults ---------------------------------------------------
    def maybe_step_fault(self, tick: int) -> None:
        """Raise ``DeviceStepFault`` if an armed step spec covers ``tick``.

        Armed specs fire on every query from ``spec.tick`` onward until
        their count drains, which keeps multi-failure runs contiguous
        even when the scheduler clock skips ticks.
        """
        for i, spec in enumerate(self.specs):
            if (spec.kind == "step" and self._remaining[i] > 0
                    and tick >= spec.tick):
                self._remaining[i] -= 1
                raise DeviceStepFault(
                    f"injected device-step fault (spec {spec.kind}@"
                    f"{spec.tick}, {self._remaining[i]} left)")

    # -- allocation faults ---------------------------------------------
    def alloc_blocked(self, tick: int) -> bool:
        """True while ``tick`` falls in an alloc spec's blocked window."""
        return any(s.kind == "alloc" and s.tick <= tick < s.tick + s.count
                   for s in self.specs)

    # -- NaN poisoning -------------------------------------------------
    def nan_victims(self, tick: int, running: Sequence[tuple]) -> List[int]:
        """Slots to poison this burst. ``running`` is a list of
        ``(slot, request_id)`` pairs for the live lanes, in slot order;
        each armed nan spec picks at most one victim per burst."""
        victims: List[int] = []
        for i, spec in enumerate(self.specs):
            if (spec.kind != "nan" or self._remaining[i] <= 0
                    or tick < spec.tick):
                continue
            pool = [s for s, rid in running
                    if (spec.slot is None or s == spec.slot)
                    and (spec.request_id is None or rid == spec.request_id)]
            if not pool:
                continue  # victim not running yet; stay armed
            self._remaining[i] -= 1
            victims.append(pool[0] if (spec.slot is not None or
                                       spec.request_id is not None)
                           else self._rng.choice(pool))
        return victims

    def __repr__(self) -> str:
        parts = []
        for s in self.specs:
            p = f"{s.kind}@{s.tick}"
            if s.count != 1:
                p += f"x{s.count}"
            if s.request_id is not None:
                p += f":req={s.request_id}"
            if s.slot is not None:
                p += f":slot={s.slot}"
            parts.append(p)
        return f"FaultPlan({','.join(parts)!r}, seed={self.seed})"
