"""mfu.open: ``mfu`` in the open-loop cell, where it moves the
problems' latency: the offered load fixes the tokens per second there."""
from portbench.metrics.mfu import read  # noqa: F401
