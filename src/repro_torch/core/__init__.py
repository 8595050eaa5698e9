"""STEP core: the paper's contribution.

  scorer        — hidden-state step scorer (2-layer MLP, weighted BCE)
  segmentation  — step-boundary detection ("\\n\\n" tokens in <think>)
  trace         — running trace-score aggregation
  pruning       — memory-aware STEP policy + SC / Slim-SC / DeepConf
  voting        — majority / score-weighted / confidence-weighted votes
"""
from repro_torch.core.pruning import (DeepConfPolicy,  # noqa: F401
                                      PruningPolicy, SelfConsistency,
                                      SingleTrace, SlimSCPolicy, StepPolicy,
                                      make_policy)
from repro_torch.core.scorer import (init_scorer,  # noqa: F401
                                     rank_accuracy, scorer_logits,
                                     scorer_score, train_scorer,
                                     ScorerTrainConfig)
from repro_torch.core.segmentation import (  # noqa: F401
    StepBoundaryDetector, extract_think, split_steps)
from repro_torch.core.trace import Trace, TraceStatus  # noqa: F401
from repro_torch.core.voting import (majority_vote,  # noqa: F401
                                     vote_breakdown, weighted_vote)
