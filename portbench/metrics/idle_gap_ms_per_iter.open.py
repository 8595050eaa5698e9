"""idle_gap_ms_per_iter.open: ``idle_gap_ms_per_iter`` in the open-loop cell, where it moves the
problems' latency: the offered load fixes the tokens per second there."""
from portbench.metrics.idle_gap_ms_per_iter import read  # noqa: F401
