"""Online request queue for the continuous-batching scheduler.

Requests carry an ``arrival_time`` (seconds relative to the start of the
serve loop). The queue releases a request to the scheduler only once the
engine clock passes its arrival time, which is what turns ``serve_batch``
from an offline batch runner into an online-serving simulation: the
scheduler admits work wave by wave as it arrives, decode keeps running
between waves, and time-to-first-token is measured against the arrival
instant rather than the batch start.

Ordering: requests are released in (arrival_time, submission index)
order, so two requests arriving at the same instant keep their
submission order — with every arrival at t=0 the scheduler sees exactly
the offline ``serve_batch`` admission sequence.

Implementation: a binary heap keyed on (arrival_time, submission index).
``push`` and ``pop_arrived`` are O(log n) per request; the previous
sorted-list implementation paid O(n) per ``push`` (insertion scan) and
per pop (``list.pop(0)`` shifts the tail), which the 10-100x larger load
scenarios turned into measurable scheduler overhead. The submission
index in the key is what preserves the stable-ordering contract above —
heaps are not otherwise stable (pinned by
``tests/test_continuous_batching.py::test_request_queue_ordering``).
"""
from __future__ import annotations

import heapq
import itertools
from typing import List, Optional, Sequence


def _arrival(request) -> float:
    """A request's arrival time; missing/None means immediately."""
    return getattr(request, "arrival_time", 0.0) or 0.0


class RequestQueue:
    """Arrival-ordered queue of not-yet-started requests."""

    def __init__(self, requests: Sequence = ()):
        self._count = itertools.count()  # submission index (tie-break)
        self._heap: List = [(_arrival(r), next(self._count), r)
                            for r in requests]
        heapq.heapify(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, request) -> None:
        """Insert a late submission, keeping arrival order."""
        heapq.heappush(self._heap,
                       (_arrival(request), next(self._count), request))

    def next_arrival(self) -> Optional[float]:
        """Arrival time of the earliest pending request (None if empty)."""
        if not self._heap:
            return None
        return self._heap[0][0]

    def pop_arrived(self, now: float) -> List:
        """Release every request whose arrival time has passed."""
        out: List = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def remove(self, request_id) -> Optional[object]:
        """Withdraw a not-yet-arrived request (cancellation before
        admission). O(n) scan + re-heapify — cancellation is rare.
        Returns the removed request, or None if absent."""
        for i, (_, _, req) in enumerate(self._heap):
            if getattr(req, "request_id", None) == request_id:
                entry = self._heap[i]
                self._heap[i] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                return entry[2]
        return None
