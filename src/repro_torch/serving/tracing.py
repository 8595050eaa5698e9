"""The engine's tracer: spans, instants and counters of its serves on the
host's clock (``time.perf_counter_ns``), with its device calls on the same
clock.

``Engine.tracer`` is :data:`NULL_TRACER` unless a caller sets a
:class:`Tracer` before a serve; the null tracer's methods do nothing, so
an untraced serve records no CUDA event, enters no profiler range and adds
no synchronize. A :class:`Tracer` keeps what it records in memory and
writes it out only on :meth:`Tracer.export`, as Chrome trace-event JSON
that Perfetto (ui.perfetto.dev) opens:

  * host spans ("X" on the host track): ``serve``; one ``round`` per
    scheduling round (a ``BudgetReplenish``, to the end of its burst's
    fold), holding ``pressure``, ``admit`` (``prefill``,
    ``prefill_chunk``, ``first_tokens``), ``write_blocks``
    (``block_copy``), ``upload``, ``decode`` (``capture``, ``launch``),
    ``sync`` and ``fold``; and ``await_arrival``, the host asleep until
    the next arrival is due. Each carries its id, its parent's id, the
    request id where it serves one request, and a few attributes;
  * device spans ("X" on the device track): CUDA events around each
    device call (``decode``, ``prefill``, ``prefill_chunk``, ``kv_write``,
    ``first_tokens``, ``block_copy``), with the id of the host span that
    made the call. They reach the host's clock through anchors: an event
    recorded where the stream is known to be empty (a serve's start,
    right after each round's sync), beside the host's clock reading. A
    span is read from the last anchor before it, so the two clocks drift
    apart over one round at most. A CPU engine's device call runs inside
    the host's call: its span is that call's host time;
  * instants ("i"): the scheduler's events, named by their class
    (``Arrival``, ``BudgetReplenish``, ``ChunkDone``, ``BurstDone``,
    ``Completion``, ``Cancelled``), and its memory decisions (``prune``,
    ``preempt``, ``evict``, ``truncate``);
  * counters ("C"), at each round's start: ``pool`` (blocks held by
    traces and prefixes, reserved by prefill jobs, parked in the prefix
    cache, free), ``queue`` (running lanes, waiting traces, queued
    requests) and ``horizon_fallbacks``; at each burst's fold, ``burst``
    (the tokens it emitted).

A tracer made with ``profiler_ranges=True`` (the default) also enters its
host spans as ``record_function`` ranges while a ``torch.profiler``
session records, so that the profile's timeline carries the same phase
names beside the device's kernels.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

_now = time.perf_counter_ns


def _profiling() -> bool:
    enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
    return bool(enabled is not None and enabled())


class _NullSpan:
    """A span that records nothing: what the null tracer hands out."""
    __slots__ = ()

    def set(self, **args) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """The default tracer: every method does nothing."""

    enabled = False

    def begin_serve(self, device, **args):
        return NULL_SPAN

    def span(self, name: str, **args):
        return NULL_SPAN

    def end(self, span) -> None:
        pass

    def add(self, name: str, t0: int, t1: int, **args) -> None:
        pass

    def annotate(self, **args) -> None:
        pass

    def device(self, name: str):
        return NULL_SPAN

    def anchor(self) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def event(self, event) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def export(self, origin_s: float = 0.0) -> dict:
        return _trace([], {"device": None, "anchors": 0})


NULL_TRACER = NullTracer()


class Span:
    """One host span; ``with`` ends it, as :meth:`Tracer.end` does."""
    __slots__ = ("name", "t0", "t1", "id", "parent", "args", "_tracer",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional[int],
                 args: dict):
        self._tracer = tracer
        self.name, self.parent, self.args = name, parent, args
        self.id = tracer._ids
        tracer._ids += 1
        self._range = None
        self.t1 = None
        self.t0 = _now()

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer.end(self)
        return False


class DeviceSpan:
    """One device call: CUDA events around it (on the CPU, its host
    time), and the host span that made it."""
    __slots__ = ("name", "host", "anchor", "ev0", "ev1", "t0", "t1",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer, self.name = tracer, name
        self.host = tracer._parent()
        self.anchor = len(tracer._anchors) - 1
        self.ev0 = self.ev1 = self.t0 = self.t1 = None

    def __enter__(self):
        if self._tracer.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        else:
            self.t0 = _now()
        return self

    def __exit__(self, *exc):
        if self._tracer.cuda:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        else:
            self.t1 = _now()
        self._tracer.device_spans.append(self)
        return False


class Tracer(NullTracer):
    """Records a serve's spans, instants and counters (see the module's
    docstring); :meth:`export` gives them as Chrome trace events."""

    enabled = True

    def __init__(self, profiler_ranges: bool = True):
        self.profiler_ranges = profiler_ranges
        self.cuda = False
        self.spans: List[Span] = []          # ended host spans
        self.device_spans: List[DeviceSpan] = []
        self.instants: List[tuple] = []      # (name, t, parent, args)
        self.counters: List[tuple] = []      # (name, t, values)
        self._stack: List[Span] = []
        self._ids = 0
        self._anchors: List[tuple] = []      # (event, host ns)

    def begin_serve(self, device, **args) -> Span:
        """Open a ``serve`` span on ``device``'s engine, first anchoring
        the device's clock: where the stream is idle, or, at the first
        traced serve, after a synchronize."""
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            if not self._anchors:
                torch.cuda.synchronize(device)
            if torch.cuda.current_stream(device).query():
                self.anchor()
        return self.span("serve", **args)

    def span(self, name: str, **args) -> Span:
        """Open a span under the innermost open one; end it with
        :meth:`end`, or use it in a ``with``."""
        sp = Span(self, name, self._parent(), args)
        if self.profiler_ranges and _profiling():
            sp._range = torch.autograd.profiler.record_function(name)
            sp._range.__enter__()
        self._stack.append(sp)
        return sp

    def end(self, span) -> None:
        """End ``span`` and every span still open inside it; a span that
        has ended already is left alone."""
        if not any(s is span for s in self._stack):
            return
        t = _now()
        while True:
            sp = self._stack.pop()
            sp.t1 = t
            if sp._range is not None:
                sp._range.__exit__(None, None, None)
                sp._range = None
            self.spans.append(sp)
            if sp is span:
                return

    def add(self, name: str, t0: int, t1: int, **args) -> None:
        """A span already timed, under the innermost open one."""
        sp = Span(self, name, self._parent(), args)
        sp.t0, sp.t1 = t0, t1
        self.spans.append(sp)

    def annotate(self, **args) -> None:
        """Set attributes on the innermost open span."""
        if self._stack:
            self._stack[-1].args.update(args)

    def device(self, name: str) -> DeviceSpan:
        return DeviceSpan(self, name)

    def anchor(self) -> None:
        """Tie the device's clock to the host's: call where the stream has
        no work left."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._anchors.append((ev, _now()))

    def instant(self, name: str, **args) -> None:
        self.instants.append((name, _now(), self._parent(), args))

    def event(self, event) -> None:
        """A scheduler event, kept whole: a handler may fill in its fields
        (``BurstDone.tokens``) after delivery."""
        self.instants.append((type(event).__name__, _now(), self._parent(),
                              event))

    def counter(self, name: str, **values) -> None:
        self.counters.append((name, _now(), values))

    def _parent(self) -> Optional[int]:
        return self._stack[-1].id if self._stack else None

    def export(self, origin_s: float = 0.0) -> dict:
        """Everything recorded so far (ended spans only) as a Chrome trace:
        ``ts`` in microseconds after ``origin_s``, a
        ``time.perf_counter()`` reading. Waits for the device first, so
        that every event can be read."""
        if self.cuda:
            torch.cuda.synchronize()
        off = origin_s * 1e6

        def us(ns: float) -> float:
            return ns / 1e3 - off

        out = []
        for sp in self.spans:
            args = {"id": sp.id, "parent": sp.parent, **sp.args}
            out.append({"ph": "X", "name": sp.name, "cat": "host",
                        "ts": us(sp.t0), "dur": (sp.t1 - sp.t0) / 1e3,
                        "pid": 1, "tid": 1, "args": args})
        for d in self.device_spans:
            if d.ev0 is not None:
                if d.anchor < 0:
                    continue   # made outside any serve: no anchor
                ev, t = self._anchors[d.anchor]
                t0 = t + ev.elapsed_time(d.ev0) * 1e6
                t1 = t + ev.elapsed_time(d.ev1) * 1e6
            else:
                t0, t1 = d.t0, d.t1
            out.append({"ph": "X", "name": d.name, "cat": "device",
                        "ts": us(t0), "dur": (t1 - t0) / 1e3, "pid": 1,
                        "tid": 2, "args": {"host": d.host}})
        for name, t, parent, args in self.instants:
            if dataclasses.is_dataclass(args):
                args = dataclasses.asdict(args)
            args = dict(args, parent=parent)
            out.append({"ph": "i", "name": name, "s": "t", "ts": us(t),
                        "pid": 1, "tid": 1, "args": args})
        for name, t, values in self.counters:
            out.append({"ph": "C", "name": name, "ts": us(t), "pid": 1,
                        "args": values})
        out.sort(key=lambda e: e["ts"])
        return _trace(out, {"device": "cuda" if self.cuda else "cpu",
                            "anchors": len(self._anchors)})


def _trace(events: list, other: dict) -> dict:
    meta = [{"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "repro_torch engine"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
             "args": {"name": "host"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
             "args": {"name": "device"}}]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": dict(other, clock="time.perf_counter_ns")}

