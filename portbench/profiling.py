"""A bounded stretch of a traced run under ``torch.profiler``, reduced to
what the metrics read: the device's operations by name and duration, the
stretch's length, the seconds in which an operation ran on the device,
and the idle gaps named by what the host was doing (the benchmark's spans
``decode_tick`` and ``prefill``; elsewhere the scheduler's host work
between device calls).
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

HOST_SPANS = ("decode_tick", "prefill")


def _ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


class Profile:
    """The one profiler session of a traced run, started at the stretch.
    Its start costs the run seconds on the card (the profiler meets the
    card, and then each decode graph at its first replay): the stretch
    leaves out its first tick, and a process makes one session only."""

    def __init__(self, cuda: bool):
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.active = False
        self.host = (0.0, 0.0)   # seconds after the recorder's origin

    def start(self, now: float) -> None:
        self.prof.start()
        self.active = True
        self.host = (now, now)

    def stop(self, now: float) -> None:
        if self.active:
            self.prof.stop()
            self.active = False
            self.host = (self.host[0], now)

    def reduce(self, top: int = 10) -> Optional[dict]:
        """The stretch: ``window_s`` from the second decode tick's start to
        the last span's end, ``busy_s`` (the union of the device's operations
        inside it), ``ops`` [(name, seconds)] inside it, ``device_ops``
        (the ``top`` names by seconds) and ``idle_gaps`` (the ``top``
        longest gaps, named by the host span around them)."""
        events = self.prof.profiler.kineto_results.events()
        spans, ops = [], []
        for e in events:
            dev = e.device_type()
            # a span shows on both timelines: its device copy is no
            # operation
            if e.name() in HOST_SPANS:
                if dev == torch.autograd.DeviceType.CPU:
                    spans.append((*_ns(e), e.name()))
            elif dev == torch.autograd.DeviceType.CUDA:
                ops.append((*_ns(e), e.name()))
        ticks = sorted(sp for sp in spans if sp[2] == "decode_tick")
        if len(ticks) < 2:
            return None
        # the first tick pays for the profiler's start on the card: the
        # stretch begins with the second
        w0, w1 = ticks[1][0], max(e for _, e, _ in spans)
        spans = [sp for sp in spans if sp[1] > w0]
        inside = [(max(s, w0), min(e, w1), n) for s, e, n in ops
                  if e > w0 and s < w1]
        busy, merged = 0, []
        for s, e, _ in sorted(inside):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        gaps = []
        edges = [w0] + [x for se in merged for x in se] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, self._host_at((a + b) / 2, spans)))
        by_name = defaultdict(int)
        for s, e, n in inside:
            by_name[n] += e - s
        return {
            "window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "ops": [(n, (e - s) / 1e9) for s, e, n in inside],
            "device_ops": [[n, t / 1e9] for n, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])
                           [:top]],
            "idle_gaps": [[n, t / 1e9] for t, n in
                          sorted(gaps, key=lambda g: -g[0])[:top]],
            "host_s": self.host}

    @staticmethod
    def _host_at(t: float, spans: List[tuple]) -> str:
        for s, e, n in spans:
            if s <= t <= e:
                return n
        return "scheduler"
