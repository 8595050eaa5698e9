"""Reasoning-step segmentation (paper §4.1, "Step Representation").

The paper extracts content between <think> and </think> and segments into
steps at tokens whose text contains "\n\n". We mirror that at both levels:

  * string level  — split_steps(text) for dataset/label construction;
  * token level   — StepBoundaryDetector marks boundary token ids so the
    engine can invoke the scorer exactly when a step-end token is emitted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Set

THINK_OPEN = "<think>"
THINK_CLOSE = "</think>"
STEP_DELIM = "\n\n"


def extract_think(text: str) -> str:
    """Content between <think> and </think> (whole text if no markers)."""
    start = text.find(THINK_OPEN)
    if start < 0:
        body = text
    else:
        body = text[start + len(THINK_OPEN):]
    end = body.find(THINK_CLOSE)
    return body if end < 0 else body[:end]


def split_steps(text: str) -> List[str]:
    """Segment reasoning content into steps at "\n\n" (paper footnote 1)."""
    steps = [s for s in extract_think(text).split(STEP_DELIM) if s.strip()]
    return steps


@dataclasses.dataclass
class StepBoundaryDetector:
    """Token-level boundary detection for online scoring.

    boundary_ids: ids of tokens whose text contains "\n\n" (paper: "any
    token whose text contains \\n\\n").
    think_close_id: emission of </think> ends the scored region.
    """
    boundary_ids: Set[int]
    think_close_id: int = -1

    def __post_init__(self):
        self.boundary_ids = set(self.boundary_ids)
        self._in_think: dict = {}

    def is_boundary(self, token_id: int) -> bool:
        return token_id in self.boundary_ids

    def boundaries(self, token_ids: Sequence[int]) -> List[int]:
        """Indices of step-end tokens within the thinking region."""
        out = []
        for i, t in enumerate(token_ids):
            if t == self.think_close_id:
                break
            if t in self.boundary_ids:
                out.append(i)
        return out
