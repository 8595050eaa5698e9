"""Answer aggregation (paper §4.3 and Table 2).

  majority_vote        — self-consistency baseline.
  weighted_vote        — STEP: trace-score-weighted majority.
  confidence_vote      — DeepConf: confidence-weighted majority.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


def _tally(answers: Sequence[Optional[str]],
           weights: Sequence[float]) -> Dict[str, float]:
    votes: Dict[str, float] = defaultdict(float)
    for a, w in zip(answers, weights):
        if a is not None and a != "":
            votes[a] += w
    return votes


def majority_vote(answers: Sequence[Optional[str]]) -> Optional[str]:
    votes = _tally(answers, [1.0] * len(answers))
    return max(votes, key=votes.get) if votes else None


def weighted_vote(answers: Sequence[Optional[str]],
                  weights: Sequence[float]) -> Optional[str]:
    votes = _tally(answers, weights)
    return max(votes, key=votes.get) if votes else None


def vote_breakdown(answers: Sequence[Optional[str]],
                   weights: Sequence[float]) -> List[Tuple[str, float]]:
    votes = _tally(answers, weights)
    return sorted(votes.items(), key=lambda kv: -kv[1])
