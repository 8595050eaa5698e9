"""Shared by the readers of the program's own trace (the record's
``program_trace``: ``repro_torch.serving.tracing``'s Chrome trace of a
traced run, its times in microseconds after the recorder's origin; see
``program_trace.py``). They
read the window's part before the profiled stretch (see ``_window.py``);
a record without the trace gives None.

The host's spans nest: ``serve`` > ``round`` > its phases (``pressure``,
``admit``, ``write_blocks``, ``upload``, ``decode`` > ``launch``,
``sync``, ``fold``), with ``await_arrival`` where the host sleeps until
an arrival is due. Device spans (``cat`` "device") are the device calls,
on the same clock."""
from __future__ import annotations

import bisect
import math
from collections import defaultdict
from typing import Dict, List, Optional

from portbench.metrics._window import stretch_start


class Spans:
    """The trace's host and device spans as (start, end, name, args),
    microseconds, and the window before the stretch: [t0, t1)."""

    def __init__(self, rec: dict, trace: dict):
        self.host, self.device = [], []
        for e in trace["traceEvents"]:
            if e["ph"] == "X":
                span = (e["ts"], e["ts"] + e["dur"], e["name"], e["args"])
                (self.host if e["cat"] == "host" else self.device).append(
                    span)
        self.host.sort(key=lambda s: (s[0], -s[1]))
        self.device.sort()
        self.t0 = rec["origin_s"] * 1e6
        start = stretch_start(rec)
        self.t1 = math.inf if start is None else start * 1e6
        self.by_id = {s[3]["id"]: s for s in self.host}

    def inside(self, span: tuple) -> bool:
        return span[0] >= self.t0 and span[1] <= self.t1

    def named(self, name: str) -> List[tuple]:
        return [s for s in self.host if s[2] == name and self.inside(s)]

    def iterations(self) -> int:
        """Decode iterations of the window's bursts (each ``decode``
        span's horizon)."""
        return sum(s[3]["horizon"] for s in self.named("decode"))

    def ancestor(self, span: tuple, name: str) -> Optional[tuple]:
        while span is not None and span[2] != name:
            span = self.by_id.get(span[3]["parent"])
        return span

    def leaves(self) -> List[tuple]:
        """The host's timeline cut into (start, end, innermost span's
        name) pieces, in order; time outside every span is left out."""
        kids = defaultdict(list)
        for s in self.host:
            kids[s[3]["parent"]].append(s)
        out = []

        def walk(span):
            t = span[0]
            for kid in kids.get(span[3]["id"], ()):
                if kid[0] > t:
                    out.append((t, kid[0], span[2]))
                walk(kid)
                t = max(t, kid[1])
            if span[1] > t:
                out.append((t, span[1], span[2]))

        for root in kids.get(None, ()):
            walk(root)
        return out

    def gaps(self) -> List[tuple]:
        """The window's idle gaps between consecutive device spans of one
        serve, as (start, end)."""
        serves = [s for s in self.host if s[2] == "serve"]
        starts = [s[0] for s in serves]

        def serve_of(t):
            i = bisect.bisect_right(starts, t) - 1
            return i if i >= 0 and t <= serves[i][1] else None

        out, end = [], None
        for d in self.device:
            if not self.inside(d):
                continue
            if end is not None and d[0] > end \
                    and serve_of(end) is not None \
                    and serve_of(end) == serve_of(d[0]):
                out.append((end, d[0]))
            end = d[1] if end is None else max(end, d[1])
        return out


def spans(rec: dict) -> Optional[Spans]:
    trace = rec.get("program_trace")
    if not trace:
        return None
    return Spans(rec, trace)


def idle_by_phase(rec: dict) -> Optional[Dict[str, float]]:
    """The window's idle gaps (``Spans.gaps``), in ms per decode
    iteration, by the host span innermost at each instant:
    ``await_arrival`` is the host asleep for arrivals, ``decode`` its
    time in the decode call outside ``launch`` (what wraps the program's
    step), ``round`` and ``serve`` the scheduler between its phases."""
    sp = spans(rec)
    if sp is None:
        return None
    iters = sp.iterations()
    if not iters:
        return None
    out: Dict[str, float] = defaultdict(float)
    leaves = sp.leaves()
    i = 0
    for g0, g1 in sp.gaps():
        while i < len(leaves) and leaves[i][1] <= g0:
            i += 1
        j = i
        while j < len(leaves) and leaves[j][0] < g1:
            a, b, name = leaves[j]
            out[name] += min(b, g1) - max(a, g0)
            j += 1
    return {k: v / 1e3 / iters for k, v in out.items()}
